"""Whether the timed path's output is correct: the written PDFs of the
window, read back by the benchmark's own readers and held against the
plain reference (``reference/``) on the same book.

Numbers compared, each with its limit (``LIMITS``; ``PERF.md`` gives the
readings each limit was set from):

    differing_books  window books whose bytes differ from the warm-up
                     book's (the configuration's guarantee: identical
                     bytes whatever the run's timing)
    pdf_faults       failed structural checks of the judged book: xref,
                     trailer ID, catalog, PDF/A-3b metadata and output
                     intent, every page with its JBIG2 mask and its fg
                     and bg images at the sizes the flags give, the
                     sampled pages' fg and bg decoding (Pillow) at them;
                     under ``force_1bit_output`` (``--bw-pdf``) every
                     page holding one 1-bit JBIG2 image at its size and
                     nothing else
    text_faults      pages whose invisible words differ from the hOCR's
    mask_mismatch    share of the judged batch's mask pixels that differ
                     from the reference's mask (under ``--bw-pdf``: the
                     page's ink as a viewer renders it)
    fg_gap, bg_gap   (Pillow JPEG2000 configurations) on the sampled
                     pages, the largest mean absolute difference between
                     the written layer and the reference's layer encoded
                     by Pillow at the configuration's flags, both decoded
                     by Pillow
    fg_err, bg_err   (the in-tree JPEG2000 coder) on the sampled pages,
                     the largest mean absolute difference between the
                     written layer, decoded by Pillow, and the
                     reference's layer: the fill, the resize, the
                     wavelet, the quantiser and Tier-1 together, held to
                     the configuration's ``layer_limits``

The judged book, batch and layer pages are drawn from the run's seed.
The configuration's flags choose the layout checked and the reference:
its ``denoise_mask`` names the reference's denoise
(``reference/denoise_<mode>.py``), and a flag the judge does not model
(``MODELLED``) makes ``judge`` raise, naming it.
"""

import hashlib
import io
import re
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .reference import jbig2, mrc, pdfread
from .roofline import thumb

# exact comparisons have the limit 0; the others are set in PERF.md
# (fg_err and bg_err in the configuration's file, ``layer_limits``)
LIMITS = {
    'differing_books': 0,
    'pdf_faults': 0,
    'text_faults': 0,
    'mask_mismatch': 0.0,
    'fg_gap': 0.0,
    'bg_gap': 0.0,
}
LAYER_PAGES = 2
# the recode flags the judge models, each with the values it models (None:
# any); recode() writes no JBIG2 mask unless ``jbig2`` is set
MODELLED = {
    'dpi': None, 'bg_downsample': None, 'fg_downsample': None,
    'jpeg2000_implementation': None, 'batch_pages': None,
    'denoise_mask': None, 'force_1bit_output': None,
    'bg_compression_flags': None, 'fg_compression_flags': None,
    'hq_bg_compression_flags': None, 'hq_fg_compression_flags': None,
    'jbig2': (True,), 'mask_compression': ('jbig2',),
}


def check_config(config):
    """Raises ValueError, naming the flag, where the configuration's recode
    flags ask for what the judge does not model, or naming the mode and
    the file looked for where its denoise mode has no reference."""
    rc = config['recode']
    for flag in sorted(set(rc) | {'jbig2'}):
        values = MODELLED.get(flag, ())
        if values is not None and rc.get(flag) not in values:
            raise ValueError('recode flag %s=%r is not modelled by the judge'
                             % (flag, rc.get(flag)))
    mrc.denoiser(mrc.denoise_mode(rc))


def bw_pdf(config):
    """Whether the configuration writes mask-only pages (``--bw-pdf``)."""
    return bool(config['recode'].get('force_1bit_output'))


def sha256(path):
    with open(path, 'rb') as fp:
        return hashlib.sha256(fp.read()).hexdigest()


def sample(seed, n_books, batches):
    """(judged book index, judged batch, its layer pages), from the seed."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 128), 0x6A756467]))
    bi = int(rng.integers(n_books))
    batch = batches[int(rng.integers(len(batches)))]
    k = min(LAYER_PAGES, len(batch))
    pages = sorted(int(p) for p in rng.choice(batch, size=k, replace=False))
    return bi, batch, pages


def _words(content):
    """The words of a page's invisible text, in order."""
    out = []
    for arr in re.findall(rb'\[\s*((?:<[0-9A-Fa-f\s]*>\s*)+)\]\s*TJ', content):
        for hx in re.findall(rb'<([0-9A-Fa-f\s]*)>', arr):
            raw = bytes.fromhex(re.sub(rb'\s', b'', hx).decode('ascii'))
            out.append(raw.decode('utf-16-be').strip())
    return out


class BookPdf:
    """A written book's parsed PDF and the faults its structure shows."""

    def __init__(self, path, book, config):
        self.faults = []
        with open(path, 'rb') as fp:
            data = fp.read()
        self.pdf = pdf = pdfread.Pdf(data)
        fault = self.faults.append
        if not re.match(rb'%PDF-1\.\d\r?\n%[\x80-\xff]{4}', data):
            fault('header')
        tr = pdf.trailer
        if not (isinstance(tr.get('ID'), list) and len(tr['ID']) == 2):
            fault('trailer ID')
        if 'Encrypt' in tr:
            fault('encrypted')
        cat = pdf.get(tr['Root'])
        if cat.get('Type') != 'Catalog':
            fault('catalog')
        xmp = pdf.get(cat.get('Metadata'))
        xmp = xmp.data() if isinstance(xmp, pdfread.Stream) else b''
        if not (re.search(rb'pdfaid:part(>|=")3', xmp)
                and re.search(rb'pdfaid:conformance(>|=")B', xmp)):
            fault('PDF/A-3b metadata')
        intents = [pdf.get(i) for i in pdf.get(cat.get('OutputIntents', []))]
        if not any(i.get('S') == 'GTS_PDFA1'
                   and isinstance(pdf.get(i.get('DestOutputProfile')),
                                  pdfread.Stream) for i in intents):
            fault('output intent')
        self.bw = bw_pdf(config)
        self.pages = pdf.pages()
        if len(self.pages) != book.pages:
            fault('%d pages, not %d' % (len(self.pages), book.pages))
        self.images = []
        self.words = []
        for i, page in enumerate(self.pages[:book.pages]):
            self.images.append(self._page_images(i, page, book, config))
            self.words.append(_words(pdf.content(page)))

    def _page_images(self, i, page, book, config):
        """(mask stream, fg stream, bg stream) of page i, or (page image,)
        under ``--bw-pdf``; faults noted."""
        pdf = self.pdf
        h, w = book.shapes[i][:2]
        res = pdf.get(page.get('Resources', {}))
        xo = {k: pdf.get(v)
              for k, v in pdf.get(res.get('XObject', {})).items()}
        images = self._bw_image(i, xo, w, h) if self.bw else \
            self._mrc_images(i, xo, w, h, config)
        if images is not None:
            mb = [float(v) for v in pdf.get(page.get('MediaBox', []))]
            dpi = book.spec['dpi']
            if len(mb) != 4 or abs(mb[2] - w * 72.0 / dpi) > 0.01 \
                    or abs(mb[3] - h * 72.0 / dpi) > 0.01:
                self.faults.append('page %d: MediaBox %s' % (i, mb))
        return images

    def _mrc_images(self, i, xo, w, h, config):
        """(mask, fg, bg): the fg's SMask the JBIG2 mask, the fg and bg JPX
        layers at the sizes the flags give."""
        fgs = [s for s in xo.values() if 'SMask' in s.dict]
        bgs = [s for s in xo.values() if 'SMask' not in s.dict]
        if len(fgs) != 1 or len(bgs) != 1:
            self.faults.append('page %d: images %s' % (i, sorted(xo)))
            return None
        fg, bg = fgs[0], bgs[0]
        mask = self.pdf.get(fg.dict['SMask'])
        fw, fh = thumb(w, h, config['recode'].get('fg_downsample'))
        bw, bh = thumb(w, h, config['recode'].get('bg_downsample'))
        want = [(mask, 'JBIG2Decode', w, h, 1), (fg, 'JPXDecode', fw, fh, 8),
                (bg, 'JPXDecode', bw, bh, 8)]
        for s, filt, ww, hh, bpc in want:
            d = s.dict
            if (d.get('Filter'), d.get('Width'), d.get('Height'),
                    d.get('BitsPerComponent')) != (filt, ww, hh, bpc):
                self.faults.append('page %d: %s image %sx%s' % (
                    i, d.get('Filter'), d.get('Width'), d.get('Height')))
                return None
        return mask, fg, bg

    def _bw_image(self, i, xo, w, h):
        """(page image,): one 1-bit JBIG2 image at the page's size, drawn
        black (DeviceGray, or an image mask), with no soft mask."""
        if len(xo) != 1:
            self.faults.append('page %d: images %s' % (i, sorted(xo)))
            return None
        s, = xo.values()
        d = s.dict
        if (d.get('Subtype'), d.get('Filter'), d.get('Width'),
                d.get('Height'), d.get('BitsPerComponent', 1)) != \
                ('Image', 'JBIG2Decode', w, h, 1) or 'SMask' in d \
                or not (d.get('ImageMask') is True
                        or d.get('ColorSpace') == 'DeviceGray'):
            self.faults.append('page %d: %s image %sx%s' % (
                i, d.get('Filter'), d.get('Width'), d.get('Height')))
            return None
        return (s,)

    def mask(self, i):
        """Page i's mask as bool (H, W), True = ink: where the mask layer
        shows the fg, or under ``--bw-pdf`` where the page is black."""
        s = self.images[i][0]
        bits = jbig2.decode(s.raw, s.dict['Width'], s.dict['Height'])
        # JBIG2Decode gives the sample 1 where the JBIG2 bit is 0 (white)
        sample = bits == 0
        if s.dict.get('Decode') == [1, 0]:
            sample = ~sample
        # a soft mask shows the fg where the sample is 1; a DeviceGray
        # image is black, and an image mask paints, where it is 0
        return ~sample if self.bw else sample


def decode_jpx(raw):
    from PIL import Image
    with Image.open(io.BytesIO(raw)) as im:
        im.load()
        return np.asarray(im)


def encode_jpx(arr, kwargs):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format='JPEG2000', **kwargs)
    return buf.getvalue()


def layer_gap(raw, ref, kwargs):
    """Mean absolute difference between a written JPX layer and the
    reference layer encoded by Pillow at ``kwargs``, both decoded."""
    mine = encode_jpx(ref, kwargs)
    if mine == raw:
        return 0.0
    return mean_abs(decode_jpx(raw), decode_jpx(mine))


def load_pages(book, idx):
    """The book's pages ``idx`` as the decoders give them (the same files
    the program read)."""
    from PIL import Image
    out = []
    for i in idx:
        with Image.open(book.files[i]) as im:
            im.load()
            out.append(np.asarray(im))
    return np.stack(out)


def reference_batch(book, config, batch, device, ftype=None, ftype64=None):
    """The reference's (mask, fg, bg) of one batch, on ``device``; (mask,)
    under ``--bw-pdf``."""
    import torch
    ftype = ftype or torch.float32
    ftype64 = ftype64 or np.float64
    pages = torch.from_numpy(load_pages(book, batch)).to(device)
    rc = config['recode']
    mask = mrc.masks(pages, [book.boxes[i] for i in batch],
                     book.spec['dpi'], ftype, ftype64,
                     denoise_mask=mrc.denoise_mode(rc))
    if bw_pdf(config):
        return (mask.cpu().numpy(),)
    fg, bg = mrc.layers(mask, pages, rc.get('bg_downsample'),
                        rc.get('fg_downsample'), ftype)
    return mask.cpu().numpy(), fg.cpu().numpy(), bg.cpu().numpy()


def mean_abs(a, b):
    """Mean absolute difference of two uint8 layers (inf where their
    shapes differ)."""
    if a.shape != b.shape:
        return float('inf')
    return float(np.abs(a.astype(np.int16) - b.astype(np.int16)).mean())


def compare(config, judged_pdf, batch, pages, ref, decoded):
    """mask_mismatch, and fg_gap and bg_gap (Pillow layers) or fg_err and
    bg_err (the in-tree coder) of one judged batch against the
    reference's (mask, fg, bg); ``decoded`` holds the sampled pages'
    written layers, decoded, by (page, 1 for fg or 2 for bg).  Under
    ``--bw-pdf``, mask_mismatch alone."""
    rmask = ref[0]
    diff = 0
    for k, i in enumerate(batch):
        try:
            diff += int((judged_pdf.mask(i) != rmask[k]).sum())
        except ValueError:      # a mask stream the decoder cannot read
            diff += rmask[k].size
    out = {'mask_mismatch': diff / float(rmask.size)}
    if bw_pdf(config):
        return out
    kws = config.get('pillow_layers')
    if kws is None:
        for i in pages:
            k = batch.index(i)
            for name, layer in (('fg_err', 1), ('bg_err', 2)):
                err = mean_abs(decoded[i, layer], ref[layer][k])
                out[name] = max(out.get(name, 0.0), err)
    else:
        jobs = []
        for i in pages:
            k = batch.index(i)
            _, fg, bg = judged_pdf.images[i]
            jobs.append(('fg_gap', fg.raw, ref[1][k], kws['fg']))
            jobs.append(('bg_gap', bg.raw, ref[2][k], kws['bg']))
        with ThreadPoolExecutor(max_workers=4) as ex:
            gaps = list(ex.map(lambda j: layer_gap(*j[1:]), jobs))
        for (name, *_), g in zip(jobs, gaps):
            out[name] = max(out.get(name, 0.0), g)
    return out


def book_batches(book, config):
    """The recode's page batches of ``book`` (``reference.mrc.batches``)."""
    return mrc.batches(['RGB' if book.rgb(i) else 'L'
                        for i in range(book.pages)],
                       [s[:2] for s in book.shapes],
                       config['recode'].get('batch_pages', 8))


def judge(book, config, pdf_paths, warm_sha, seed, device):
    """(checks {name: (value, limit)}, correct) for a run whose window
    wrote ``pdf_paths``; ``warm_sha`` is the warm-up book's digest.
    Raises ValueError for a configuration it does not model
    (``check_config``)."""
    check_config(config)
    values = {'differing_books': sum(sha256(p) != warm_sha
                                     for p in pdf_paths)}
    bi, batch, pages = sample(seed, len(pdf_paths), book_batches(book, config))
    try:
        judged = BookPdf(pdf_paths[bi], book, config)
    except (ValueError, KeyError, IndexError, TypeError, AttributeError,
            zlib.error):
        # a file the reader cannot walk is a broken PDF
        values.update(text_faults=book.pages, pdf_faults=1)
        return _checks(values, config), False
    text = 0
    for i in range(min(book.pages, len(judged.words))):
        if judged.words[i] != ['synthword'] * len(book.boxes[i]):
            text += 1
    values['text_faults'] = text + max(0, book.pages - len(judged.words))
    decoded = {}
    for i in pages:
        images = judged.images[i] or ()
        for layer, s in list(enumerate(images))[1:]:
            # every layer of the sampled pages decodes at its size
            try:
                decoded[i, layer] = decode_jpx(s.raw)
                shape = decoded[i, layer].shape[:2]
            except (OSError, ValueError, SyntaxError):
                shape = None
            if shape != (s.dict['Height'], s.dict['Width']):
                judged.faults.append('page %d: a JPX layer does not decode '
                                     'at its size' % i)
    values['pdf_faults'] = len(judged.faults)
    if judged.faults:
        return _checks(values, config), False
    ref = reference_batch(book, config, batch, device)
    values.update(compare(config, judged, batch, pages, ref, decoded))
    return verdict(values, config)


def limits(config):
    """{number: limit}: the exact ones and the configuration's own."""
    return dict(LIMITS, **config.get('layer_limits', {}))


def _checks(values, config):
    return {k: (v, lim) for k, lim in limits(config).items()
            for v in (values.get(k),) if v is not None}


def verdict(values, config):
    """(checks {name: (value, limit)}, correct) of the numbers read."""
    checks = _checks(values, config)
    return checks, all(v <= lim for v, lim in checks.values())
