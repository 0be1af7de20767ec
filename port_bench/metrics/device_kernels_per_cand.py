"""Device events (kernels, copies, sets, each once) launched in the
profiled calls, per candidate."""


def read(rec):
    s = rec.summary
    if s is None or not rec.profiled_cands or not s.device_events:
        return None
    return s.device_events / rec.profiled_cands
