"""Mean device ms a traced unit of the DINO step's ``dn_loss`` span
(``parallel/train.py``, inside ``loss``: the denoising queries' targets,
and their focal, L1 and GIoU terms at every decoder layer): the device
work between its begin and end markers in each graph replay
(``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "dn_loss")
