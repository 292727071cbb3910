"""Share of the traced stretch in which no operation ran on the card (%).
The reader of every ``device.idle.<cells>`` metric: one a kind of cell, as
each moves its cells' end-to-end metric."""

from portbench.harness.readers import idle_percent


def read(run):
    return idle_percent(run)
