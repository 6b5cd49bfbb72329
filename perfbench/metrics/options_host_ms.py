"""Mean host ms of ``graphed.options`` a traced step: reading the train
step's optimizer options (``parallel/train.py`` ``_options``) and comparing
them with the capture's (``perfbench/spans.py``)."""

from perfbench.spans import host_ms


def read(run):
    return host_ms(run, "graphed.options")
