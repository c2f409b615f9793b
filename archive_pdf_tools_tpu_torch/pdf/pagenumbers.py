# Copied from archive_pdf_tools_tpu/pdf/pagenumbers.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Page-number series parsing -> PDF /PageLabels.

Same capability as the reference's ``pagenumbers.py:52-300``: classify
scan page numbers (arabic / roman / alpha), split them into monotone
runs, and emit the PDF PageLabels number tree.  Roman numeral handling
is self-contained (the reference depends on the ``roman`` package).
"""

import re

INVALID, ARABIC, ROMAN_LOWER, ROMAN_UPPER, ALPHA_UPPER, ALPHA_LOWER = range(6)

TYPE_NAMES = {
    INVALID: 'Invalid',
    ARABIC: 'Arabic',
    ROMAN_LOWER: 'Roman lower',
    ROMAN_UPPER: 'Roman upper',
    ALPHA_UPPER: 'Alpha upper',
    ALPHA_LOWER: 'Alpha lower',
}

_PDF_STYLE = {
    ARABIC: '/D',
    ROMAN_LOWER: '/r',
    ROMAN_UPPER: '/R',
    ALPHA_UPPER: '/A',
    ALPHA_LOWER: '/a',
}

_ARABIC_RE = re.compile(r'^[0-9]+$')
_ALPHA_UPPER_RE = re.compile(r'^[A-Z]+$')
_ALPHA_LOWER_RE = re.compile(r'^[a-z]+$')
_ROMAN_RE = re.compile(
    r'^M{0,4}(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})$')

_ROMAN_VALUES = (('M', 1000), ('CM', 900), ('D', 500), ('CD', 400),
                 ('C', 100), ('XC', 90), ('L', 50), ('XL', 40),
                 ('X', 10), ('IX', 9), ('V', 5), ('IV', 4), ('I', 1))


class InvalidRomanNumeral(ValueError):
    pass


def roman_to_int(s):
    """Strict roman numeral parse (same acceptance set as the ``roman``
    package used at ``pagenumbers.py:26``)."""
    if not s or not _ROMAN_RE.match(s):
        raise InvalidRomanNumeral(repr(s))
    total = 0
    i = 0
    for sym, val in _ROMAN_VALUES:
        while s[i:i + len(sym)] == sym:
            total += val
            i += len(sym)
    return total


def _is_roman(s):
    try:
        roman_to_int(s.upper())
        return True
    except InvalidRomanNumeral:
        return False


def alpha_to_number(n):
    """Evince-style alpha numbering: A=1..Z=26, AA=27, ZZ=52, AAA=53
    (``pagenumbers.py:80-99``)."""
    first = True
    res = 1
    for c in n:
        tmp = ord(c) - ord('A')
        res += tmp
        if first:
            first = False
        else:
            res += 26 - tmp
    return res


def value_type(v, ignore_invalid=False):
    """Classify one page-number string (``pagenumbers.py:102-121``);
    roman is preferred over alpha."""
    if v is None:
        return INVALID
    if _ARABIC_RE.match(v) and v.isnumeric():
        return ARABIC
    if v.lower() == v and _is_roman(v):
        return ROMAN_LOWER
    if v.upper() == v and _is_roman(v):
        return ROMAN_UPPER
    if _ALPHA_UPPER_RE.match(v):
        return ALPHA_UPPER
    if _ALPHA_LOWER_RE.match(v):
        return ALPHA_LOWER
    if ignore_invalid:
        return INVALID
    raise ValueError('Page number not in spec: %s' % repr(v))


def value_of(v, vtype):
    """Numeric value under a given classification (``pagenumbers.py:124-137``)."""
    if v and ' ' in v:
        v = v.strip().split(' ')[0]
    if vtype == INVALID:
        return None
    if vtype == ARABIC:
        return int(v, 10)
    if vtype in (ROMAN_LOWER, ROMAN_UPPER):
        try:
            return roman_to_int(v.upper())
        except InvalidRomanNumeral:
            raise ValueError(v)
    if vtype in (ALPHA_LOWER, ALPHA_UPPER):
        return alpha_to_number(v.upper())


def _next_nonnull(series):
    for v in series:
        if v is not None:
            return v
    return None


def parse_series(series, ignore_invalid=False):
    """Split a page-number sequence into monotone same-type runs
    (``pagenumbers.py:147-258``).  Returns (runs, all_ok)."""
    last_value = None
    last_type = INVALID
    start = 0
    runs = []
    all_ok = True
    vals, nums = [], []

    for idx, val in enumerate(series):
        try:
            vtype = value_type(val, ignore_invalid=ignore_invalid)
            vval = value_of(val, vtype)
        except ValueError:
            all_ok = False
            vtype, vval = INVALID, None

        # roman/alpha disambiguation against the next non-null value
        if vtype in (ROMAN_UPPER, ROMAN_LOWER):
            nxt = _next_nonnull(series[idx + 1:])
            ntype = value_type(nxt, ignore_invalid=ignore_invalid)
            if vtype != ntype and (
                    (vtype == ROMAN_UPPER and ntype == ALPHA_UPPER) or
                    (vtype == ROMAN_LOWER and ntype == ALPHA_LOWER)):
                vtype = ntype
                vval = value_of(val, vtype)
        elif vtype in (ALPHA_UPPER, ALPHA_LOWER):
            nxt = _next_nonnull(series[idx + 1:])
            ntype = value_type(nxt, ignore_invalid=ignore_invalid)
            consecutive = (isinstance(val, str) and isinstance(nxt, str)
                           and len(val) == 1 and len(nxt) == 1
                           and ord(val) == ord(nxt) - 1)
            if nxt is None or consecutive or vtype == ntype:
                pass
            elif (vtype == ALPHA_UPPER and ntype == ROMAN_UPPER) or \
                 (vtype == ALPHA_LOWER and ntype == ROMAN_LOWER):
                try:
                    vtype = ntype
                    vval = value_of(val, vtype)
                except ValueError:
                    vtype, vval = INVALID, None
            else:
                # e.g. invalid roman followed by arabic: treat as invalid
                vtype, vval = INVALID, None

        new = vtype != last_type
        if not (vtype == INVALID and last_type == INVALID):
            if last_type == INVALID or vtype == INVALID:
                new = True
            elif vval != last_value + 1:
                new = True

        if new and idx != 0:
            runs.append({'start': start, 'type': last_type,
                         'type_human': TYPE_NAMES[last_type],
                         'values': vals, 'values_numeric': nums})
            start = idx
            vals, nums = [], []

        vals.append(val)
        nums.append(vval)
        last_value = vval
        last_type = vtype

    runs.append({'start': start, 'type': last_type,
                 'type_human': TYPE_NAMES[last_type],
                 'values': vals, 'values_numeric': nums})
    return runs, all_ok


def series_to_pagelabels(runs):
    """Runs -> python structure for the /PageLabels number tree
    (PDF 32000 12.4.2; replaces the string templating of
    ``pagenumbers.py:280-300``)."""
    from .writer import Name
    nums = []
    for run in runs:
        nums.append(run['start'])
        if run['type'] == INVALID:
            nums.append({})
        else:
            nums.append({Name('S'): Name(_PDF_STYLE[run['type']][1:]),
                         Name('St'): run['values_numeric'][0]})
    return {Name('Nums'): nums}
