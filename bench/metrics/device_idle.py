"""Share of the traced window in which no operation ran on the card: one
less the union of the device's operation intervals over the window."""


def read(run):
    from bench.harness.readers import idle_pct
    return idle_pct(run)
