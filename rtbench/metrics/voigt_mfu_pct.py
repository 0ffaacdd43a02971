"""The whole call's share of the card's f32 peak: the census operations
of every Voigt sample the traced calls need (both methods, both bands,
lit columns' shortwave only), over the calls' wall time at the published
67 TFLOP/s.  It names no kernel, so it bounds a gain whatever implements
the Voigt sums."""


def read(record: dict):
    census = record.get("census")
    wall = record.get("call_wall_s")
    if not census or not wall or not record.get("device_ops"):
        return None
    ops = sum(k["ops"] for k in census.values())
    return 100.0 * ops / (wall * record["peak_f32_ops"])
