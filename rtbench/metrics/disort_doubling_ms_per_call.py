"""Device milliseconds per call of the program's
``grtcode::disort_doubling`` layers, the discrete-ordinates solver's
phase matrices, delta-M scaling and layer doublings, summed over its
wavenumber blocks and the window's replays of captured steps by the
program's own timing events, over the window's calls.  Withheld unless
every replay of the window was timed, and where the program has no such
layer."""

LAYER = "grtcode::disort_doubling"


def read(record: dict):
    if record.get("layer_untimed") != 0:
        return None
    return (record.get("layer_ms") or {}).get(LAYER)
