"""The share of the discrete-ordinates solver's doubling steps that the
layers' optical depths need: the program's device counter of the steps
each (column, layer, wavenumber) element needs, over the steps the solver
runs for all of them, counted after the window less before it
(``step_stats()["disort"]``).  None where the program keeps no such
counter or ran no step of the solver."""


def read(record: dict):
    counts = (record.get("step_stats") or {}).get("disort")
    if not counts or not counts.get("run"):
        return None
    return 100.0 * counts["needed"] / counts["run"]
