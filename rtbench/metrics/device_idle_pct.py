"""The device's idle share of the traced window: one minus the union of
its operations' intervals over the window's length."""


def read(record: dict):
    if not record.get("device_ops") or not record.get("window_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
