"""Mean device ms a traced unit of the decoder's span (``models/detr.py``:
the decoder layers, box refinement and the heads): the device work between
its begin and end markers in each graph replay
(``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "decoder")
