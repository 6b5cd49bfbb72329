"""Mean device ms a traced unit of ``postprocess``'s span
(``models/detr.py``: the scores, the top-k and the boxes): the device work
between its begin and end markers in each graph replay
(``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "postprocess")
