"""How often a ``-J pillow`` layer encode runs off the process that
drives the card: the window's ``jp2_pillow`` records (a layer encoded in
an encode worker process, stored by the pool thread that waited for it)
over its ``fg_jp2`` and ``bg_jp2`` spans, in %.  0 where every layer is
encoded on the pool's threads, as in a program without encode workers;
None under another coder than Pillow's (``-J tpu``) or where the window
holds no layer span."""

from portbench import spans


def read(run):
    if run.recode_flags.get('jpeg2000_implementation', 'pillow') != 'pillow':
        return None
    win = spans.window(run)
    if win is None:
        return None
    layers = sum(r.name in ('fg_jp2', 'bg_jp2') for r in win.records)
    if not layers:
        return None
    offloaded = sum(r.name == 'jp2_pillow' for r in win.records)
    return 100.0 * offloaded / layers
