"""The least time the card could take for the chi^2 work of the profiled
calls' core inputs (``roofline.py``) over the device time of the device
events launched inside the cores' ranges."""


def read(rec):
    s = rec.summary
    if s is None or s.core_device_s <= 0 or rec.bound_s <= 0:
        return None
    return 100.0 * rec.bound_s / s.core_device_s
