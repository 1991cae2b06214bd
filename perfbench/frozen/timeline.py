"""Device-timeline arithmetic over a profiler trace, frozen: the union of
the kernels' intervals (the port's `profile_step._busy_ms`), the idle
gaps between them, and the host op that was open during each gap."""

from __future__ import annotations


def busy_s(spans) -> float:
    """Union length in s of (start_us, end_us) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(spans, start_us: float, end_us: float):
    """The idle intervals (start_us, end_us) of the device inside [start_us,
    end_us], between the union of `spans`."""
    out, cur = [], start_us
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, end_us)))
        cur = max(cur, e)
        if cur >= end_us:
            break
    if cur < end_us:
        out.append((cur, end_us))
    return [(a, b) for a, b in out if b > a]


def open_host_op(host_ops, t_us: float) -> str:
    """The innermost host op (name, start_us, end_us) open at t_us, or "idle"."""
    best = None
    for name, s, e in host_ops:
        if s <= t_us <= e and (best is None or s >= best[1]):
            best = (name, s, e)
    return best[0] if best else "idle"
