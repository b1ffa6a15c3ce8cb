"""The device (one card) in the closed loop: 1 - (the device's busy time a
traced frame, the union of its kernel, copy and set intervals) / (this
run's `loop_frame_ms`, taken in the untraced window), in %. The busy time
is the card's own work, which the profiler does not stretch; the frame
time is the loop's own pace."""


def read(ctx):
    t = ctx["trace"]
    busy_ms = t["summary"]["busy_us"] * 1e-3 / t["frames"]
    return 100.0 * (1.0 - busy_ms / ctx["e2e"]["loop_frame_ms"])
