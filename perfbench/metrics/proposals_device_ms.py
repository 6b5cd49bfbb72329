"""Mean device ms a traced unit of the published two-stage detector's
``proposals`` span (``models/detr.py``, inside ``decoder``: the proposal
projection and norm, the encoder's class and box heads over every token,
the top-k, the sine embedding and ``pos_trans``): the device work between
its begin and end markers in each graph replay (``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "proposals")
