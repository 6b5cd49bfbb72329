"""Mean device ms a traced unit of the train step's ``proposal_loss`` span
(``parallel/train.py``, inside ``loss``: the published two-stage proposal
term's matching cost over every token, its auction on the large-N path,
and its loss): the device work between its begin and end markers in each
graph replay (``perfbench/spans.py``)."""

from perfbench.spans import device_ms


def read(run):
    return device_ms(run, "proposal_loss")
