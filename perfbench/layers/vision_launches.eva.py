"""Kernel-launch calls of a served request in the EVA02 vision tower: the
program's span ``vision.eva`` (inside ``pipeline.forward``), from the
requests a traced run profiles with the host's activity and spans on.
Nothing where the program has no such span or the profile missed launches
(``lib/spans.layer_calls``, its 2% rule)."""
from perfbench.lib import spans

VISION = ("vision.eva",)


def read(data, cell):
    return spans.layer_calls(data, "launches", VISION)
