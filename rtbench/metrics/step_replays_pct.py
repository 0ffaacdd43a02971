"""The share of the window's steps that replayed a captured graph: the
driver's step-cache replays over its eager steps, captures and replays,
counted after the window less before it."""


def read(record: dict):
    stats = record.get("step_stats")
    if not stats:
        return None
    steps = stats["eager"] + stats["captures"] + stats["replays"]
    return 100.0 * stats["replays"] / steps if steps else None
