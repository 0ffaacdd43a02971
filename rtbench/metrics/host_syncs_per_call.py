"""Host-device synchronisations inside ``RadiationDriver.run`` per call
(the driver and its step cache: ``_inputs``, ``_surface_spectra``, the
limits check, the compaction gathers, the replays), counted by the
traced run's sync counter around ``run()`` only."""


def read(record: dict):
    if not record.get("calls") or record.get("syncs") is None:
        return None
    return record["syncs"] / record["calls"]
