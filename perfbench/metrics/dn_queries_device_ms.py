"""Mean device ms a traced unit of the DINO detector's ``dn_queries`` span
(``models/detr.py``, inside ``decoder``: the denoising queries' draws,
label noise and embedding, box noise, and the group mask's look-up): the
device work between its begin and end markers in each graph replay
(``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "dn_queries")
