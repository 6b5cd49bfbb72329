"""Mean device ms a traced unit of the encoder's span (``models/detr.py``:
the input projections and the encoder layers): the device work between its
begin and end markers in each graph replay (``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "encoder")
