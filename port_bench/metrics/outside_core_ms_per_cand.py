"""Host milliseconds of a traced run's unprofiled calls outside the
likelihood cores (samplers, priors, the reduction, the frontend and the
batch orchestration), per candidate."""


def read(rec):
    if not rec.starts or rec.core_host_s <= 0:
        return None
    walls = sum(b - a for a, b in zip(rec.starts, rec.ends))
    return 1e3 * (walls - rec.core_host_s) / sum(rec.cands)
