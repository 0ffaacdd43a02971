"""K2's share of its roofline: the census bound of the bin-method work
the traced calls need (fine samples by class and the remote lines' three
points each; bytes once), over the device time of the kernel's symbol
in the trace.  Withheld where the dispatchers' launches differ from the
census's, which would then count other work than the program ran."""

SYMBOLS = ("voigt_bins_kernel",)
WORK = "k2"


def read(record: dict):
    work = record.get("census", {}).get(WORK)
    ops = record.get("device_ops") or {}
    seconds = sum(s for name, s in ops.items()
                  if any(k in name for k in SYMBOLS))
    if not work or seconds <= 0.0 or \
            record.get("launches_agree") is False:
        return None
    return 100.0 * work["bound_s"] / seconds
