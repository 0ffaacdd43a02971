"""Device time per call of every device operation that is not a Voigt
kernel (line prep, bin interpolation, continua, CFC and CIA, Rayleigh,
the solvers, the integrals, the compaction's gathers and copies), from
the profiler's trace."""

VOIGT_SYMBOLS = ("voigt_line_sample_kernel", "voigt_bins_kernel")


def read(record: dict):
    ops = record.get("device_ops")
    if not ops or not record.get("calls"):
        return None
    other = sum(s for name, s in ops.items()
                if not any(k in name for k in VOIGT_SYMBOLS))
    return 1e3 * other / record["calls"]
