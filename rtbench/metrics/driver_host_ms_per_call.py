"""Host milliseconds per call inside ``RadiationDriver.run`` besides its
steps: the program's ``grtcode::run`` spans less their
``grtcode::step_eager``, ``step_capture`` and ``step_replay`` spans, in
the traced window (the driver's inputs and surface spectra, the limits
check, the gathers and the scatter-back)."""

RUN = "grtcode::run"
STEPS = ("grtcode::step_eager", "grtcode::step_capture",
         "grtcode::step_replay")


def read(record: dict):
    spans = record.get("host_spans") or {}
    if RUN not in spans or not record.get("calls"):
        return None
    inside = spans[RUN] - sum(spans.get(k, 0.0) for k in STEPS)
    return 1e3 * inside / record["calls"]
