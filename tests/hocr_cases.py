"""hOCR that is not well-formed XML, and what the JAX package's reader
(``archive_pdf_tools_tpu/inputs/hocr.py`` over lxml's recovering parser)
reads from it.

``CASES`` are the rows of ROADMAP C16 (an undefined entity with and
without the XHTML DOCTYPE, a bare '&', an unclosed ``<meta>``, a file
cut short, a byte that is not UTF-8, '<' inside a word, an unclosed
``<i>``); ``mutated(seed)`` is a generated document (words_to_hocr_page
pages) with '<', '&', '>', '"' and bytes that are not UTF-8 inserted or
deleted after its DOCTYPE, and some cut short; ``book_hocr(words)`` is
the 3-page worded book of ``chip_smoke.py`` phase 3b with four of the
C16 faults in it.

``PINS`` holds, for each case, the sha256 of what the JAX reader gives
(``digest``: every page's dimensions, scan resolution and word data, in
the order the pages come), and ``PIN_WORDS`` the word texts a page of the
C16 rows and of the book.  tests/test_torch_hocr.py writes both
(``python tests/test_torch_hocr.py``) and checks that they are current;
``chip_smoke.py`` phase 3g holds the port's reader to them on a machine
without lxml.  Nothing here imports lxml, torch or either package.
"""

import hashlib
import importlib.util
import io
import json
import os
import random

N_MUTATED = 200
# words of the generated pages, some of them not ASCII
VOCABULARY = ['the', 'café', 'über', 'Hi', 'A', 'x', 'naïve', 'end.',
              'p1', 'q']
# what a mutation inserts: the markup characters and bytes that are not
# UTF-8
INSERTS = [b'<', b'&', b'>', b'"', b'\xff', b'\xfe', b'\x80', b'\xc3']


_FIXTURES = []


def _fixtures():
    """tests/fixtures.py, loaded by path (chip_smoke.py loads this file
    so, with no 'tests' package on the path)."""
    if _FIXTURES:
        return _FIXTURES[0]
    spec = importlib.util.spec_from_file_location(
        'hocr_cases_fixtures',
        os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     'fixtures.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _FIXTURES.append(mod)
    return mod


def _line(texts, y=20):
    """Words in one line, 30 pixels apart."""
    return [(10 + 30 * k, y, 35 + 30 * k, y + 15, t)
            for k, t in enumerate(texts)]


def _document(pages, head=None, doctype=True, cut=0):
    """An hOCR document (bytes) of ``pages`` (a list of word lists, each
    word ``(x1, y1, x2, y2, text)`` with the text as written into the
    markup); ``head`` replaces the template's head, ``cut`` drops that
    many bytes at the end."""
    fx = _fixtures()
    text = fx.HOCR_TEMPLATE % '\n'.join(
        fx.words_to_hocr_page(words, 300, 400, page_no=i, dpi=300)
        for i, words in enumerate(pages))
    if head is not None:
        a = text.index('<head>')
        b = text.index('</head>') + len('</head>')
        text = text[:a] + head + text[b:]
    if not doctype:
        a = text.index('<!DOCTYPE')
        text = text[:a] + text[text.index('>', a) + 2:]
    data = text.encode('utf-8')
    return data[:len(data) - cut] if cut else data


def _cases():
    """name -> bytes, the C16 rows."""
    two = [_line(['one', 'two']), _line(['three'], y=50)]
    return {
        'nbsp_doctype': _document([_line(['Hi&nbsp;there', 'next'])]),
        'nbsp_no_doctype': _document([_line(['Hi&nbsp;there', 'next'])],
                                     doctype=False),
        'bare_amp': _document([_line(['A&B', 'next'])]),
        'meta_unclosed': _document([_line(['page'])],
                                   head='<head><meta charset="utf-8">'
                                        '</head>'),
        'cut_20': _document(two, cut=20),
        'cut_60': _document(two, cut=60),
        'bad_byte': _document([_line(['o@k', 'café', 'über'])]).replace(
            b'o@k', b'o\xffk'),
        'lt_in_word': _document([_line(['a<b', 'c']), _line(['p1'])]),
        'unclosed_i': _document([_line(['<i>it', 'x']), _line(['p1'])]),
    }


CASES = _cases()


def mutated(seed):
    """A generated 1-3 page document with 1-3 insertions or deletions
    after its DOCTYPE, cut short at a random place one time in five."""
    rng = random.Random(seed)
    pages = []
    for _ in range(rng.randint(1, 3)):
        words = []
        for line in range(rng.randint(0, 3)):
            words += _line([rng.choice(VOCABULARY)
                            for _ in range(rng.randint(1, 4))],
                           y=10 + 20 * line)
        pages.append(words)
    data = bytearray(_document(pages))
    lo = data.index(b'<html')
    for _ in range(rng.randint(1, 3)):
        if rng.random() < 0.5:
            k = rng.randrange(lo, len(data) + 1)
            data[k:k] = rng.choice(INSERTS)
        else:
            marks = [k for k in range(lo, len(data)) if data[k] in b'<&>"']
            del data[rng.choice(marks)]
    if rng.random() < 0.2:
        del data[rng.randrange(lo, len(data)):]
    return bytes(data)


def book_hocr(pages_words):
    """The hOCR of phase 3b's book (``pages_words``: each page's words
    from ``fixtures.render_book_page(320, 416, ...)``) with an undefined
    ``&nbsp;`` in page 0, a bare '&' in page 1, an unclosed ``<meta>`` in
    the head and the file cut inside page 2's last line."""
    fx = _fixtures()
    pages = []
    for i, words in enumerate(pages_words):
        words = list(words)
        if i == 0:
            x1, y1, x2, y2, _ = words[1]
            words[1] = (x1, y1, x2, y2, 'Hi&nbsp;there')
        if i == 1:
            x1, y1, x2, y2, _ = words[0]
            words[0] = (x1, y1, x2, y2, 'A&B')
        pages.append(fx.words_to_hocr_page(words, 320, 416, page_no=i,
                                           dpi=100))
    text = fx.HOCR_TEMPLATE % '\n'.join(pages)
    text = text.replace('</head>', '<meta charset="utf-8">\n</head>')
    data = text.encode('utf-8')
    # inside the last word span of the last page
    return data[:data.rindex(b'</span>', 0, data.rindex(b'</span>')) - 3]


def read(module, data):
    """What ``module`` (an ``inputs/hocr.py``) reads from ``data``: per
    page, its dimensions, scan resolution and word data.  Where the
    reader raises (a bbox that is not numbers, an ``x_size`` with no
    value), the exception's type and message end the list."""
    out = []
    try:
        for page in module.hocr_page_iterator(io.BytesIO(data)):
            out.append([module.hocr_page_get_dimensions(page),
                        module.hocr_page_get_scan_res(page),
                        module.hocr_page_to_word_data(page)])
    except Exception as exc:
        out.append([type(exc).__name__, str(exc)])
    return out


def digest(pages):
    """sha256 of ``read``'s result."""
    return hashlib.sha256(json.dumps(pages, sort_keys=True).encode(
        'utf-8')).hexdigest()


def words(pages):
    """The word texts of each page of ``read``'s result."""
    return [[w['text'] for para in wd for line in para['lines']
             for w in line['words']] for _dims, _res, wd in pages]


# -- written by tests/test_torch_hocr.py from the JAX reader ---------------
PINS = {'bad_byte': '6927c076c3e1d6722fda91d8527abc8d97b2c602df847721ce07da612da0003c',
 'bare_amp': '229949f7b7bd04d92adadfd8421bd4b0a7b27aa76f9cbc9344daefc6ab6028a8',
 'book': 'f36041e9d9e854ceaf3548766a33f99387da2cf4ebcae180681154195dcaa07b',
 'cut_20': '43b8212bf7e64f38cff95126019fa0df65d47ee662daf021c68282f05e8fd3fa',
 'cut_60': '9acf2580c0999417a00c6143cf5d67f9b871070d94b1654ec1d562b18c563caf',
 'lt_in_word': '392c5c3a00eaf52138cdca516c48e5b5afda71f8a33982740d8af7d188e01fce',
 'meta_unclosed': 'ba449a363e5e01187d9636b5316cab0f5829fb020113e6251fdf58bcd1e41441',
 'mutated_000': 'f2beaed637be7d37afe6667d590366342387ebc1cdc620990f03a3ec51fa66fd',
 'mutated_001': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_002': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_003': '73cdce690ad82640dbbe758958bef914f4b8c0385274a6993d272e7d2d919fcf',
 'mutated_004': '5c5a38d3a304f2b1b0831b3c93037f08ff544cb67f48821e8d5b6b37925ea93a',
 'mutated_005': 'f7e66d09cd8f839ac37e997eb2f87cdc44cd106a7648beced3ca7eea9021d6c1',
 'mutated_006': 'fd2fb49876c2828db4f95ebabd8509668fd50bf82cea631cf65f6c76e14eeca9',
 'mutated_007': '8a4b7938f6af7205fd84f7af0df6fc518c19cac6307fe00a53813e4ac2ea4e90',
 'mutated_008': '74e8d6787410f2d62c3c53f90fa45e4581ccce260c3ffd745e1fb56ebc6ef01e',
 'mutated_009': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_010': '77b8630a20c41a4b2ac646d0a8f18485a11b36086c18830a60297598a8ee24eb',
 'mutated_011': '1ab12be5b5641acf8d0ddb0c1dba2ba34043414348470fc39039f05ac4193a95',
 'mutated_012': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_013': 'da25b410f2e894b47fb81376b88a03cf80a33766b04dc6952f5db2cb5a620a8c',
 'mutated_014': '5cbc17e7415c7963d10f4c1dedb1b5fb1e0f5386c2c97b7c36475e433af05aaa',
 'mutated_015': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_016': '0a09833182a1bf8562f388453dd0895610c8a7d98e39f5539489dc80bc48fce6',
 'mutated_017': '0c2d200aea712b164ca06854cbd6e8ca36e4dc0e2f376cd12a698e746fca821e',
 'mutated_018': 'da25b410f2e894b47fb81376b88a03cf80a33766b04dc6952f5db2cb5a620a8c',
 'mutated_019': '048e06d37de5cc6ab5f53276e5f293f4ef0c700a4f6e53ec90ec83da1dcce856',
 'mutated_020': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_021': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_022': '7ac288363e2cabe113ce1b3adf0a701d86405b352d5c472cb4f9a8b929b06d0c',
 'mutated_023': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_024': 'c05d7dd6f078f1874e5e0cdd52864696d4f0b660d67c1412ea2f2dd65139850a',
 'mutated_025': '22368b9c66c2a87cbd829c119958f27280b13d76756a1dfe110e208e4078bc3b',
 'mutated_026': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_027': '586b646456aa785bef3c08a75aa52bd3ed88a75f17d832c626a6b04fd5b93661',
 'mutated_028': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_029': 'aed1ea840355b6b2504ec944be17a0d9143ff569d291397ba7f90ad6522099c0',
 'mutated_030': '02eec1ec455814991f565e0494df073f447e6e011521a972a8af05965ae26d39',
 'mutated_031': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_032': '770c58b2651e8412afad30a2d3366a1bf893ee6fe81a1d3cd7d5046217d54a55',
 'mutated_033': '86d0fb09743729e04ccc94af20acb0c7ed172df4cce3c16d7871c374be325337',
 'mutated_034': 'f686bed0d124b8b9e761052a414b6996638a6a7cb597ba6cd249e28f8044851b',
 'mutated_035': '47cd1ebe06237addc870f043e9ab716fd2d4993f5811b9ba08b626540c63a5d5',
 'mutated_036': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_037': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_038': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_039': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_040': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_041': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_042': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_043': '2314a3eec5044d87229507550baad0bf34436db660e43ea91346a8850217a34c',
 'mutated_044': 'a8aab7c30b9a14d71776687e3779971a2ee2cd0ff8bde0bc65beeba3634692f0',
 'mutated_045': '9fbe9f5c66bcc22e2bd09df79171c9145e8a8c7e02ab13691f63ce340c2bfb6c',
 'mutated_046': '4920890d9558295d6c034221afa2b73adff6afe2e681d55cc557069d57509b25',
 'mutated_047': '6996fd4b1b0ff39b1514f0b22c95a062d079e968e376647987b27949c03129b5',
 'mutated_048': 'b5001e2f9c373e0552282b3505f5c32e639a94ccc8ee0bb7834f5aead5c49449',
 'mutated_049': '78c6df3bdc1b4b81a8f12d179a7ca7a4e3c8db33ba72789beac8449011465500',
 'mutated_050': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_051': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_052': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_053': 'ba252bcb3630bf3da3da39518de0f211ea76039a790572a70f76e2d831ef36ff',
 'mutated_054': '98b3d2b0ca965f8ab6a1c82f38b960f233cab453537e50c3cdbf68babcc65d02',
 'mutated_055': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_056': 'cc323b1e4618f4a645064e7a7850e6d742b858ecacec6b971356ae81e3eda0a0',
 'mutated_057': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_058': 'fce584e7a53db3ec5ecbaff7e727ab9a44c6e0203612b2745d0cb70132db4ecb',
 'mutated_059': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_060': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_061': 'd558bd9101904097efad4ee6087a96f159c8efedfd88008adcdeac289a90384f',
 'mutated_062': '23958915d1ed9246e4de35054aaddfa35f93939b6a2bf2402b574b8f2f6fb1c5',
 'mutated_063': '3ec3317259ba100d3ebfb234d16bdb956488b0169e5370312aabce4cbd4b5161',
 'mutated_064': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_065': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_066': 'ac2ebf45857ae340b6fc114de27b1f7ba7d3b2a0fefb3fd0dc8c5aa334149ef8',
 'mutated_067': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_068': '3aba05d930a1587112efb0158898d88fc4b71a62aeaecf8cc987f9fdb1a11733',
 'mutated_069': '77b8630a20c41a4b2ac646d0a8f18485a11b36086c18830a60297598a8ee24eb',
 'mutated_070': '7dbcafef9346783b447b84cb5dbfb647aebcee20619198870f5f1c4a06025113',
 'mutated_071': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_072': '7d4c425f6a5a3c885213fca6e8bb33194123f1be971deab00730a6ee08184530',
 'mutated_073': 'bbadd8f858c5d77aaddab3e961e5b7f1305d2861dcc52174d7bb5b787eaafda9',
 'mutated_074': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_075': 'da25b410f2e894b47fb81376b88a03cf80a33766b04dc6952f5db2cb5a620a8c',
 'mutated_076': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_077': 'd8d287fc023d5f1ca049daa61d6de79cc873d9547694d2f04af6ef9c30c0be75',
 'mutated_078': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_079': '4e095ee483092daa6169c8bae7f7f1b1710324a0ebf133f891ffe2cf88a230e0',
 'mutated_080': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_081': '1e74f6748e497d7a65020d2122db6c615dbc482a10c59daac9686f1663185165',
 'mutated_082': 'da25b410f2e894b47fb81376b88a03cf80a33766b04dc6952f5db2cb5a620a8c',
 'mutated_083': '2861b5f08832b247ef2ed7904b2eeb85b18566eb20519432291cef930388e816',
 'mutated_084': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_085': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_086': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_087': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_088': 'ee6dcc74aa1a96182638fb6405c30ba7550c85c504f1724cb910659f5aca81ee',
 'mutated_089': 'f7de145e7d0f201602d9e5451290aa25da7c7900563870a04c9872603454466f',
 'mutated_090': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_091': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_092': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_093': 'b5001e2f9c373e0552282b3505f5c32e639a94ccc8ee0bb7834f5aead5c49449',
 'mutated_094': '32663048a00d746d770a1184ddd487a7360c2e6e4e0c1f6703987fae1f7ffc00',
 'mutated_095': '5902cdf126937dcd40c91356d5acc1588582a3ec0cc6ea1feef01b4f65911ea1',
 'mutated_096': '0c574ffa2dab2f870eb4331dd839f32b51e535d021cf75e0c62fd26592e25f1d',
 'mutated_097': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_098': '6a672336e18293eac0e4e71665f2dba99f06c5f37a983e0a7fdee32c2fe9af95',
 'mutated_099': '734eb09e9728cb13d24184ade8dda1ac356ca9bc6ddc271939ec4b50acce5dd9',
 'mutated_100': '4dc36776fb641b3370a422673f1c17babb18776d7eb5a78551e18e5750705958',
 'mutated_101': 'e0e27d4025d55279edb12cc79ae8298cd39c3bb1202b86cfddcbfa756648a8db',
 'mutated_102': '4617711f279d07f2a577a3f939096882b3adc7db3009b34fc1849528ca70795f',
 'mutated_103': 'b14cc6edd77f446d5f93deee503fccfacd694486e3b34373ee7079c523ead3d6',
 'mutated_104': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_105': '7f77716c2d23631ec778f3db1f261b94134bf5022a86effd5307902a141f34e4',
 'mutated_106': '16fe8661776a65aad2c137bd874fb26d69d624aacef32ee7a986fbe9586f06fd',
 'mutated_107': '30c9741929de9711b9bef0e73987ac0b02bdd30b7a933856667850d94ee03b06',
 'mutated_108': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_109': 'b6571709bcc67ada48c20ec26c287f2a8da047e92209522d354f2c17d7646cb0',
 'mutated_110': '500bb8565c144d064ba78caa709d5fd589e705ecf4e8e44ab628d6ef02c98e89',
 'mutated_111': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_112': 'da25b410f2e894b47fb81376b88a03cf80a33766b04dc6952f5db2cb5a620a8c',
 'mutated_113': '44d296643d57e2ea178ae6fda7d87eb0b1fe617ff41247054a1a46b7f033d775',
 'mutated_114': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_115': '6f1178c24924697bf3e1e403ad8fbb971cb9ee7a7fdd73c1e88bf780660565a8',
 'mutated_116': '105f6b36be07af81665f2661ee7806e0fce27eb71f820b58d8964371b73028ab',
 'mutated_117': '2ec129b1a955e85591b877974c602ba85c9f4b784073e417f1819c95f8021dfb',
 'mutated_118': '77b8630a20c41a4b2ac646d0a8f18485a11b36086c18830a60297598a8ee24eb',
 'mutated_119': '42465750fc4b82455ea928a50034d78cb93ffea1807b269295f4612fb6e4c9b3',
 'mutated_120': 'e00c2991a48380eb94366f2715946c93eb9a22999e369e4446d61dc7213434b2',
 'mutated_121': '96f77081ed5b9e023d7ff20fa76245a9e815f95f31989707f5c5a96d5f026d3a',
 'mutated_122': '911e1dbf2cd8662a19e8ae0ec994bc2d617a50979e0c11ef5bc68c01cb6be65d',
 'mutated_123': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_124': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_125': 'b36dedabc1cf90be656e4e5f5700a2cdea366b68cfbd36ebea5ddb1e0a121a9b',
 'mutated_126': '512b3164d47c52fd174e23f45395dcde393e89298baeb148a08f478adb572ae5',
 'mutated_127': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_128': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_129': 'beb05244e21022af06fc85033e19d9d4679abc709294e020fa2b34f199c1970b',
 'mutated_130': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_131': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_132': 'f10aa2e3f81b15a79b3df240da649a04876f7fde9e6c0c35cf120e2533b64b2d',
 'mutated_133': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_134': 'b5001e2f9c373e0552282b3505f5c32e639a94ccc8ee0bb7834f5aead5c49449',
 'mutated_135': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_136': '0d5aac63e4c0e670d3ba461655ab2de3a5967c04cf68ea5fc6be9044c057f86e',
 'mutated_137': '10420978b4cf7f8e3df35bda6254f41dc7e07621253b5d596bbc4e3315b46ea4',
 'mutated_138': '18f21ffc7fce8c7b73f4c322a79fd2819abe1562cc90ffa4fac7aefb85300796',
 'mutated_139': 'dfe954483cbaf45826ee482aa628bba449c25f2c5fc1c96a6d22237069c7d27a',
 'mutated_140': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_141': 'e82c995d2147ff0027a30457ae3390f3110ea95c69642ad9294f47a433087e85',
 'mutated_142': '1c51a6eae510c5678caf579df0584822964b29576fcecb81c136b4169d15c377',
 'mutated_143': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_144': '52ad4ca08f9a688a8beeacdba1721468e2d307a5ea9525710227f4a5513b8934',
 'mutated_145': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_146': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_147': '78beef8e53d99c7bf9c856b3ecf243d1bd1f509ea67387866a2b08a2fc83ff78',
 'mutated_148': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_149': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_150': '6430a7f1f8eefb27b42b9801934da2ae6956a890669b21021b936613b38d3309',
 'mutated_151': '4ae2024e32e41b91b7e61060692ccc71dcca9cc5b920b9bff8033d6a4d7fd9a5',
 'mutated_152': '831f6de28ecfeb5ccffaf6d1989b302771917f98eedd5f73f960b27f487cb679',
 'mutated_153': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_154': 'cd51c6a136599dadcfe89e124ea1e165ab8e1d0ec9d4a22e7a7652e69de4b896',
 'mutated_155': 'e6a812ba7f7a7a8a6390ffd28c7f15776a31af6963e4ac0e199cdb597f622ada',
 'mutated_156': 'cc511d9c706e93927aa0b0cc5458971ce37442ade49197908e8c44dcfdf9a646',
 'mutated_157': 'dd6c35f1df8030caf782f2fc0a8065c9a1539f964f9d4641dc013b7ca2b0ff86',
 'mutated_158': 'ca321c319d698e45831757d9e9f2fc2caaf56396f489c2a64b511327980e2a5e',
 'mutated_159': '67a028d9447119ab2deef90952ddf1350776c704a367eef997f0d8f056038f9b',
 'mutated_160': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_161': 'fbe89813a7262b749a81ddccd1dd22231c60c7fa5c7249cbc5bf61b06f1c93b0',
 'mutated_162': 'cfcb1ec08c16f204483f312f082b311fd5e3a2511408751ad89f9d9ae9161aca',
 'mutated_163': '94924e0af8d0ab6e5775413328c9fc6ec899549e58234857678cc18ce1219202',
 'mutated_164': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_165': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_166': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_167': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_168': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_169': 'f2369ffcef3982b796d416141c7dad39d2031f34a6bdf9fd8b94e6474a4cbce7',
 'mutated_170': 'b5001e2f9c373e0552282b3505f5c32e639a94ccc8ee0bb7834f5aead5c49449',
 'mutated_171': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_172': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_173': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_174': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_175': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_176': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_177': '1ff42cf236fd43d03a8ecce0e87339e47247ff6d51ca8af03f69a21430616683',
 'mutated_178': '2ddca9a4bffe07178c339a59da34b4f2097e2d864ca1f4a0c41b887f9df2969c',
 'mutated_179': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_180': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_181': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_182': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_183': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_184': '4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945',
 'mutated_185': 'ca7538d0524dd436b9b97854ee530e9a595efe62cb406d905c271705298e5362',
 'mutated_186': '53f5e3f244fee183e2c7f281dc91253a1151964a4380ea3cf07f9d33635e95ef',
 'mutated_187': '818037e5a79407f49b65f220934319941583e8870636fea14847bdab250e0b05',
 'mutated_188': '66424b7a17345cf0359705f271706c4ed17bb430555547815f5332ca1fc3a4bf',
 'mutated_189': '99f10132e7482ec46e76f832df11239e9c593ebefbcda2d9b6e1c4aa8655d2ff',
 'mutated_190': '227b32c03da04c0764dc7d3045c89d926bccf405f0c0a88c0468766d4a29d341',
 'mutated_191': 'b5a6e2b7403f3a33fc6c709fff5507415a16f5d0204e1ca4eebc4a17b9bf1b8f',
 'mutated_192': 'a6643264b3283b0edcfd353296f3c77b61a6ccedee16afed93ed6d2c73a5eb54',
 'mutated_193': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_194': '907e392cf88095da7011d38932ebb43119335c46d743fdb79ea7638cd4bd7537',
 'mutated_195': 'ab202ed5495e6967e392cb6391f60530b239eebfb454e51dd032ffb0d063ba6e',
 'mutated_196': '671069744b0e57a21b195ee52a4f3fed4156cae99e224af47fa56b42b1b843d6',
 'mutated_197': '61d513b09474f043899ddc7a4e4fb4c6cc813c38607abd86aed32c56fe3ffec8',
 'mutated_198': '65772d1c02741f8b092f1df67edb8eb971830728a3affc09b708ce40cd1a78b1',
 'mutated_199': 'cddd3d5edb3fbf8396fb2cdc927255aaa9d966ee068bc0cae3bd43cb28ed963b',
 'nbsp_doctype': '0cd8d6a84fc47c4178614ee8d93ee3674e4b4c2105c3244fe80d23fe6bdd8982',
 'nbsp_no_doctype': '0cd8d6a84fc47c4178614ee8d93ee3674e4b4c2105c3244fe80d23fe6bdd8982',
 'unclosed_i': 'af51a1288e19673d5865f2e4e1eff28e447a68d3808b5ddb23fb4487e3525f3f'}
PIN_WORDS = {'bad_byte': [['o�k', 'café', 'über']],
 'bare_amp': [['A', 'next']],
 'book': [['word00', 'Hithere', 'word02', 'word03', 'word10', 'word11',
           'word12', 'word13', 'word20', 'word21', 'word22', 'word23',
           'word30', 'word31', 'word32', 'word33', 'word40', 'word41',
           'word42', 'word43', 'word50', 'word51', 'word52', 'word53'],
          ['A', 'word01', 'word02', 'word03', 'word10', 'word11', 'word12',
           'word13', 'word20', 'word21', 'word22', 'word23', 'word30',
           'word31', 'word32', 'word33', 'word40', 'word41', 'word42',
           'word43', 'word50', 'word51', 'word52', 'word53'],
          ['word00', 'word01', 'word02', 'word03', 'word10', 'word11',
           'word12', 'word13', 'word20', 'word21', 'word22', 'word23',
           'word30', 'word31', 'word32', 'word33', 'word40', 'word41',
           'word42', 'word43', 'word50', 'word51', 'word52', 'wor']],
 'cut_20': [['one', 'two'], ['three']],
 'cut_60': [['one', 'two'], []],
 'lt_in_word': [['p1'], ['a', 'c']],
 'meta_unclosed': [['page']],
 'nbsp_doctype': [['Hithere', 'next']],
 'nbsp_no_doctype': [['Hithere', 'next']],
 'unclosed_i': [['p1'], []]}
# -- end of the pins ---------------------------------------------------------
