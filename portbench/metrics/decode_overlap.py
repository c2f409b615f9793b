"""How many page decodes run at once while any runs: the summed wall
time of the window's ``image_load`` records, on any thread or in any
worker process (one clock for every process), over the length of the
union of their intervals.  1 where the decodes run one at a time; None
where the window holds no ``image_load`` record (or none that lasts)."""

from portbench import spans


def read(run):
    win = spans.window(run)
    if win is None:
        return None
    loads = sorted((r.start_ns, r.end_ns) for r in win.records
                   if r.name == 'image_load')
    union = reach = 0
    for start, stop in loads:
        union += max(0, stop - max(start, reach))
        reach = max(reach, stop)
    if not union:
        return None
    return sum(stop - start for start, stop in loads) / union
