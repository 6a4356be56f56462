"""``wrappers.self_us``: the kernel wrappers' own host time a launch, in
microseconds: the sum over the traced window's scenes of
``run_simulation``'s ``timings["compute.wrappers"]`` (the launch loop's
calls into the wrappers, less the time inside the library's launch
calls) over the launches counted in the window. None where the program
times no wrappers or counts no launch."""


def read(record):
    times = [r["timings"]["compute.wrappers"] for r in record["scenes"]
             if "compute.wrappers" in r["timings"]]
    if not times or not record["launches"]:
        return None
    return 1e6 * sum(times) / record["launches"]
