"""K1's share of its roofline: the census bound of the line_sample work
the traced calls need (operations at the f32 peak or bytes at the memory
peak, whichever binds, summed over the band-molecule launches), over
the device time of the kernel's symbol in the trace.  Withheld where
the dispatchers' launches differ from the census's, which would then
count other work than the program ran."""

SYMBOLS = ("voigt_line_sample_kernel",)
WORK = "k1"


def read(record: dict):
    work = record.get("census", {}).get(WORK)
    ops = record.get("device_ops") or {}
    seconds = sum(s for name, s in ops.items()
                  if any(k in name for k in SYMBOLS))
    if not work or seconds <= 0.0 or \
            record.get("launches_agree") is False:
        return None
    return 100.0 * work["bound_s"] / seconds
