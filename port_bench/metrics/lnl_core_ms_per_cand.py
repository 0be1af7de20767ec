"""Host milliseconds inside the likelihood cores (lnL_planet, lnL_eb) per
candidate, over a traced run's unprofiled calls (host-clock spans the
benchmark puts around the cores)."""


def read(rec):
    if not rec.starts or rec.core_host_s <= 0:
        return None
    return 1e3 * rec.core_host_s / sum(rec.cands)
