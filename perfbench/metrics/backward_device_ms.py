"""Mean device ms a traced unit of the train step's ``backward`` span
(``parallel/train.py``): the device work between its begin and end markers
in each graph replay (``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "backward")
