"""The one traffic generator: a book of scanned pages and its hOCR, made
from a traffic file's parameters and the run's seed.

A traffic file (``traffic/<name>.json``) holds only data:

    pages        pages in the book
    height       page rows, width: page columns, dpi: scan resolution
    page_set     the seed of the book's page set: every run's book holds
                 the same pages
    rgb_pages    indices of the pages stored as RGB (sepia), the rest gray
    noise_sigma  sensor noise of ``scan.synth_scan``
    format       ``png`` (lossless) or ``jp2`` (Pillow's irreversible
                 JPEG2000 at ``jp2_rate``:1)
    words        (optional, default true) false: the hOCR holds every
                 page and no line (a book whose OCR found no words); the
                 pixels are the same

Each page has one hOCR word a text line, unless ``words`` is false.  Every run's book holds the
same pages: page variant ``v`` is drawn from ``page_set`` and ``v``.  The
run's seed puts the gray pages in an order of its own (the RGB pages
keep their places), so two runs with one seed make the same files, and
every seed makes a book of the same pages, sizes, modes and formats,
batched in other groups.

The variants are written once into a cache directory keyed by the
traffic file's content (``portbench/.build/pages/`` in a run) by worker
processes (spawn; they import numpy, scipy and Pillow only); a run's
book links them in its seed's order and writes its hOCR.
"""

import hashlib
import json
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor

import numpy as np

REQUIRED = ('pages', 'height', 'width', 'dpi', 'page_set', 'rgb_pages',
            'noise_sigma', 'format')
FORMATS = ('png', 'jp2')


def load(path):
    """A traffic file's parameters, checked."""
    with open(path) as fp:
        spec = json.load(fp)
    missing = [k for k in REQUIRED if k not in spec]
    if missing:
        raise ValueError('%s: missing %s' % (path, ', '.join(missing)))
    if spec['format'] not in FORMATS:
        raise ValueError('%s: format must be one of %s' % (path, FORMATS))
    if spec['format'] == 'jp2' and 'jp2_rate' not in spec:
        raise ValueError('%s: a jp2 book needs jp2_rate' % path)
    if not isinstance(spec.get('words', True), bool):
        raise ValueError('%s: words must be true or false' % path)
    return spec


def page_seed(seed, page):
    """The seed of one page variant, from a seed (any size) and its index."""
    state = np.random.SeedSequence([int(seed) % (1 << 128), page]) \
        .generate_state(2, np.uint32)
    return int(state[0]) << 32 | int(state[1])


def page_order(spec, seed):
    """The page variant at each place of the run's book: the RGB places
    keep their own variant, the gray variants shuffled by the seed."""
    gray = [i for i in range(spec['pages']) if i not in spec['rgb_pages']]
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 128), 0x6F72646572]))
    order = list(range(spec['pages']))
    for place, variant in zip(gray, rng.permutation(gray)):
        order[place] = int(variant)
    return order


def make_variant(spec, variant):
    """(uint8 page, line boxes [(x0, y0, x1, y1)]): the pixels of page
    variant ``variant``, gray or sepia RGB, and the boxes of its text
    lines."""
    from .scan import synth_scan
    img, wd = synth_scan(h=spec['height'], w=spec['width'],
                         seed=page_seed(spec['page_set'], variant),
                         dpi=spec['dpi'],
                         noise_sigma=float(spec['noise_sigma']),
                         fast_paper=True)
    if variant in spec['rgb_pages']:
        img = np.stack([img, (img * 0.93).astype(np.uint8),
                        (img * 0.82).astype(np.uint8)], axis=-1)
    boxes = [tuple(line['bbox']) for para in wd for line in para['lines']]
    if not spec.get('words', True):
        boxes = []
    return img, boxes


def spec_key(spec):
    """The cache key of a traffic file's parameters."""
    text = json.dumps(spec, sort_keys=True, separators=(',', ':'))
    return hashlib.sha256(text.encode('utf-8')).hexdigest()[:16]


def variant_name(spec, variant):
    return 'variant_%04d.%s' % (variant, spec['format'])


def _write_variant(spec, variant, var_dir):
    """Writes variant ``variant``'s page file and its boxes and shape
    (``.json``), each under a temporary name moved into place."""
    from PIL import Image
    img, boxes = make_variant(spec, variant)
    path = os.path.join(var_dir, variant_name(spec, variant))
    tmp = '%s.%d.tmp' % (path, os.getpid())
    im = Image.fromarray(img)
    if spec['format'] == 'png':
        im.save(tmp, format='PNG')
    else:
        im.save(tmp, format='JPEG2000', quality_mode='rates',
                quality_layers=[float(spec['jp2_rate'])], irreversible=True)
    os.replace(tmp, path)
    with open(tmp, 'w') as fp:
        json.dump({'boxes': boxes, 'shape': list(img.shape)}, fp)
    os.replace(tmp, path + '.json')
    return variant


def _variant_meta(spec, var_dir, variant):
    path = os.path.join(var_dir, variant_name(spec, variant))
    with open(path + '.json') as fp:
        meta = json.load(fp)
    return path, [tuple(b) for b in meta['boxes']], tuple(meta['shape'])


def page_name(spec, page):
    return 'page_%04d.%s' % (page, spec['format'])


class Book:
    """A written book: its page files (``glob``), hOCR file, and what the
    reference needs to hand the same input to both sides."""

    def __init__(self, spec, out_dir, boxes, shapes):
        self.spec = spec
        self.boxes = boxes
        self.shapes = shapes
        self.files = [os.path.join(out_dir, page_name(spec, i))
                      for i in range(spec['pages'])]
        self.glob = os.path.join(out_dir, 'page_*.' + spec['format'])
        self.hocr = os.path.join(out_dir, 'book.hocr')

    @property
    def pages(self):
        return len(self.files)

    def rgb(self, page):
        return len(self.shapes[page]) == 3

    def write_hocr(self):
        from .hocr import HOCR_TEMPLATE, words_to_hocr_page
        parts = []
        for i, (boxes, shape) in enumerate(zip(self.boxes, self.shapes)):
            words = [tuple(b) + ('synthword',) for b in boxes]
            parts.append(words_to_hocr_page(words, shape[1], shape[0],
                                            page_no=i, dpi=self.spec['dpi']))
        with open(self.hocr, 'w', encoding='utf-8') as fp:
            fp.write(HOCR_TEMPLATE % '\n'.join(parts))


class BookMaker:
    """Makes a book while the caller goes on: the variants missing from
    ``cache_dir`` (by default a directory of the book's own) are written
    in worker processes; ``wait`` links the book's pages to them in the
    seed's order and returns the written ``Book``."""

    def __init__(self, spec, seed, out_dir, workers=None, cache_dir=None):
        os.makedirs(out_dir, exist_ok=True)
        self.spec, self.seed, self.dir = spec, seed, out_dir
        self.var_dir = os.path.join(cache_dir or os.path.join(out_dir,
                                                              'variants'),
                                    spec_key(spec))
        os.makedirs(self.var_dir, exist_ok=True)
        n = spec['pages']
        missing = [v for v in range(n) if not os.path.exists(os.path.join(
            self.var_dir, variant_name(spec, v) + '.json'))]
        self.pool = None
        self.futures = []
        if missing:
            workers = workers or min(8, os.cpu_count() or 1, len(missing))
            self.pool = ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context('spawn'))
            self.futures = [self.pool.submit(_write_variant, spec, v,
                                             self.var_dir) for v in missing]

    def close(self):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)

    def wait(self):
        try:
            for f in self.futures:
                f.result()
        finally:
            self.close()
        spec = self.spec
        boxes, shapes = [], []
        for page, variant in enumerate(page_order(spec, self.seed)):
            path, b, shape = _variant_meta(spec, self.var_dir, variant)
            os.symlink(path, os.path.join(self.dir, page_name(spec, page)))
            boxes.append(b)
            shapes.append(shape)
        book = Book(spec, self.dir, boxes, shapes)
        book.write_hocr()
        return book


def make_book(spec, seed, out_dir, workers=None, cache_dir=None):
    return BookMaker(spec, seed, out_dir, workers, cache_dir).wait()
