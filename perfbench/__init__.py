"""The benchmark of ``msda_tpu_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line.  The harness (``harness.py``) finds each piece by its name:
``configs/<config>.json``, ``traffic/<mix>.json`` (which names its driver,
``drivers/<driver>.py``), ``metrics/<metric>.py`` and
``limits/<cell>.json``.  ``reference/`` is the plain PyTorch reference
that decides ``correct``; ``arith/`` holds the peaks, the MSDA bound and
the model's operation counts.  Nothing here imports JAX or the JAX
package.
"""
