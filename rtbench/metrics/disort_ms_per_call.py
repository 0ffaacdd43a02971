"""Device milliseconds per call of the program's ``grtcode::disort``
layer, the discrete-ordinates shortwave solver (``disort_shortwave``),
summed over the window's replays of captured steps by the program's own
timing events, over the window's calls.  Withheld unless every replay of
the window was timed: a sum over fewer replays would read low."""

LAYER = "grtcode::disort"


def read(record: dict):
    if record.get("layer_untimed") != 0:
        return None
    return (record.get("layer_ms") or {}).get(LAYER)
