"""Candidates vetted per second: every candidate of every completed call
of the window over the time from the first call's start to the last
call's end (host clock)."""


def read(rec):
    if not rec.starts:
        return None
    return sum(rec.cands) / (rec.ends[-1] - rec.starts[0])
