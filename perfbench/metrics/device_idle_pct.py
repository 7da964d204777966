"""The share of the traced window that the union of device intervals
leaves empty, in %."""


def read(ctx):
    w = ctx.window
    if w is None or w.window_s <= 0:
        return None
    busy = w.busy_s()
    ctx.log(f"device_idle_pct: busy {busy!r} s of {w.window_s!r} s "
            f"(CUDA events {w.event_ms!r} ms), {busy / w.substeps * 1e3!r} ms "
            f"of device work a substep against the measured window's "
            f"{ctx.run_s / ctx.substeps * 1e3!r} ms")
    return 100.0 * (1.0 - busy / w.window_s)
