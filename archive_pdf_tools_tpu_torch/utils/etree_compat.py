"""The part of ``lxml.etree`` that ``cli/epub_to_pdf.py`` calls, on the
standard library alone.

``cli/epub_to_pdf.py`` is a copy of the JAX package's converter with its
``from lxml import etree`` pointed here (``tools/copy_shared.py``), and
machines without lxml run it.  So this module builds the tree lxml
builds, down to the nodes the converter looks at:

- ``fromstring(data)`` parses XML with expat, namespaces resolved as
  libxml2 resolves them (it recovers from a bad prefix or declaration,
  and lxml raises only when an error is the parse's last message).
  Comments and processing instructions stay in the tree as children
  whose ``tag`` is not a ``str`` (``Comment`` /
  ``ProcessingInstruction``), each with its own ``tail``; CDATA joins
  the text; no DTD default attribute is added and no external entity
  loaded; ``XMLSyntaxError`` is raised where lxml raises it.
- ``fromstring(data, HTMLParser(encoding=...))`` is libxml2's
  recovering HTML parser as lxml 6.1 (libxml2 2.14) runs it: an HTML5
  tokenizer (character references, raw text and RCDATA elements, script
  data escapes, bogus comments, per-byte U+FFFD for bad input) under
  libxml2's own tree rules: implied ``html``/``head``/``body``, its
  start-tag auto-close table (``htmlStartClose``), end-tag priorities
  (``htmlEndPriority``), void elements, misplaced ``html``/``head``/
  ``body`` tags dropped, and whitespace kept wherever an element is
  open.  The tables were read off lxml by ``tests/test_torch_etree.py``,
  which holds this module against lxml.
- Elements have ``tag``, ``text``, ``tail``, ``attrib``, ``get``,
  iteration, ``iter(tag)`` (``'{*}name'`` matches any namespace),
  ``find``/``findall``, ``getparent()`` and an ``itertext()`` that skips
  the text of comments and processing instructions but keeps their
  tails.  ``QName(el_or_tag).localname`` raises ``ValueError`` where
  lxml does (comments, names that are not NCNames).

Nothing else of lxml is here.
"""

import codecs
import re
import xml.etree.ElementPath as _ElementPath
import xml.parsers.expat as _expat
from html.entities import html5 as _NAMED_REFS


class XMLSyntaxError(SyntaxError):
    """A document that is not well-formed XML."""


def Comment(text=None):
    """The ``tag`` of a comment node (as ``lxml.etree.Comment``)."""
    return _Element(Comment, None, text)


def ProcessingInstruction(target, text=None):
    """The ``tag`` of a processing-instruction node."""
    return _Element(ProcessingInstruction, None, text)


class _Element:
    __slots__ = ('tag', 'attrib', 'text', 'tail', '_children', '_parent')

    def __init__(self, tag, attrib=None, text=None):
        self.tag = tag
        self.attrib = dict(attrib) if attrib else {}
        self.text = text
        self.tail = None
        self._children = []
        self._parent = None

    def append(self, child):
        child._parent = self
        self._children.append(child)

    def __iter__(self):
        return iter(self._children)

    def get(self, key, default=None):
        return self.attrib.get(key, default)

    def getparent(self):
        return self._parent

    def iter(self, tag=None):
        """This node and its descendants in document order; with a tag,
        the elements of that tag only (``'{*}name'``: any namespace)."""
        if tag is None:
            match = None
        elif tag.startswith('{*}'):
            local, suffix = tag[3:], '}' + tag[3:]

            def match(t):
                return isinstance(t, str) and (t == local or
                                               t.endswith(suffix))
        else:
            def match(t):
                return t == tag
        stack = [self]
        while stack:
            node = stack.pop()
            if match is None or match(node.tag):
                yield node
            stack.extend(reversed(node._children))

    def itertext(self):
        """The text of this element and of the elements inside it, with
        the tails of its descendants; comments and processing
        instructions give their tails only (as lxml)."""
        if self.text is not None and isinstance(self.tag, str):
            yield self.text
        for child in self._children:
            if isinstance(child.tag, str):
                yield from child.itertext()
            if child.tail is not None:
                yield child.tail

    def find(self, path):
        return _ElementPath.find(self, path)

    def findall(self, path):
        return _ElementPath.findall(self, path)


def _append_text(el, text):
    """``text`` after what ``el`` holds: its text, or its last child's
    tail."""
    if el._children:
        last = el._children[-1]
        last.tail = (last.tail or '') + text
    else:
        el.text = (el.text or '') + text


# NCName (XML 1.0 fifth edition Name, no colon): what lxml accepts as
# the local part of a tag
_NAME_START = ('A-Z_a-z\xc0-\xd6\xd8-\xf6\xf8-\u02ff\u0370-\u037d'
               '\u037f-\u1fff\u200c\u200d\u2070-\u218f\u2c00-\u2fef'
               '\u3001-\ud7ff\uf900-\ufdcf\ufdf0-\ufffd'
               '\U00010000-\U000effff')
_NCNAME = re.compile('[%s][%s.0-9\xb7\u0300-\u036f\u203f\u2040-]*\\Z'
                     % (_NAME_START, _NAME_START))


class QName:
    """``QName(element_or_tag).localname``."""

    def __init__(self, text_or_element):
        tag = text_or_element
        if isinstance(tag, _Element):
            tag = tag.tag
        if not isinstance(tag, str):
            raise ValueError('Invalid input tag of type %r' % type(tag))
        if tag.startswith('{'):
            tag = tag[tag.find('}') + 1:]
        if not tag:
            raise ValueError('Empty tag name')
        if not _NCNAME.match(tag):
            raise ValueError('Invalid tag name %r' % tag)
        self.localname = tag


class HTMLParser:
    """Selects the recovering HTML parser for ``fromstring``; the bytes
    are decoded with ``encoding`` (any ``<meta charset>`` is ignored, as
    lxml does when the parser names one)."""

    def __init__(self, encoding):
        self.encoding = encoding


def fromstring(text, parser=None):
    """The root element of ``text`` (bytes).  XML unless ``parser`` is
    an ``HTMLParser``; the HTML parser returns None for a document with
    no element, as lxml does."""
    if parser is not None:
        return _parse_html(text, parser.encoding)
    b = _XMLTreeBuilder()
    m = _ENCODING_DECL.match(text)
    override = None
    if m:
        # libxml2 spells UTF-8 two ways (Python's lookup takes any
        # spelling); expat decodes UTF-16, Latin-1 and ASCII itself and
        # gets the rest as UTF-8
        name = m.group(3).decode('ascii')
        try:
            codec = codecs.lookup(name).name
        except LookupError:
            codec = None
        if name.upper() in ('UTF-8', 'UTF8'):
            override = 'utf-8'
        elif codec in (None, 'utf-8'):
            raise XMLSyntaxError('Unsupported encoding %r' % name)
        elif codec not in _EXPAT_CODECS:
            try:
                text = text.decode(codec).encode('utf-8')
            except UnicodeDecodeError as exc:
                raise XMLSyntaxError(str(exc)) from None
            override = 'utf-8'
    p = _expat.ParserCreate(override)
    b.parser, b.source = p, text
    p.buffer_text = True
    p.specified_attributes = True     # no ATTLIST defaults, as lxml
    p.XmlDeclHandler = b.xml_decl
    p.StartElementHandler = b.start
    p.EndElementHandler = b.end
    p.CharacterDataHandler = b.text
    p.StartCdataSectionHandler = b.cdata
    p.CommentHandler = b.comment
    p.ProcessingInstructionHandler = b.pi
    p.SkippedEntityHandler = b.skipped_entity
    p.ExternalEntityRefHandler = b.external_entity
    try:
        p.Parse(text, True)
    except (_expat.ExpatError, LookupError) as exc:
        # once it has recovered from an error, libxml2 reads no more
        # than comments and processing instructions after the root
        tail = None if b.root_end is None else _MISC.match(text, b.root_end)
        if not (b.recovered and tail and not tail.group(1)
                and _decodes(tail.group(0))):
            raise XMLSyntaxError(str(exc)) from None
    if b.last_error:
        raise XMLSyntaxError(b.last_error)
    return b.root


def _decodes(data):
    try:
        data.decode('utf-8')
    except UnicodeDecodeError:
        return False
    return True


_ENCODING_DECL = re.compile(
    rb'<\?xml[ \t\r\n]+version[ \t\r\n]*=[ \t\r\n]*(["\'])[^"\']*\1'
    rb'[ \t\r\n]+encoding[ \t\r\n]*=[ \t\r\n]*(["\'])'
    rb'([A-Za-z][A-Za-z0-9._-]*)\2')
# whitespace, comments and processing instructions after the root, and
# the start of one that is not well-formed
_CONTROLS = rb'\0-\x08\x0b\x0c\x0e-\x1f'      # not XML characters
_MISC = re.compile(rb'(?:\s|<!--(?:[^-%s]|-[^-%s])*-->|<\?(?:[^?%s]|\?[^>%s])*'
                   rb'\?>)*(<!--|<\?)?' % ((_CONTROLS,) * 4))
_TAG = re.compile(rb'<(?:[^>"\']|"[^"]*"|\'[^\']*\')*>')
_EXPAT_CODECS = {'utf-16', 'utf-16-le', 'utf-16-be', 'iso8859-1', 'ascii'}
_XML_NS = 'http://www.w3.org/XML/1998/namespace'
_XMLNS_NS = 'http://www.w3.org/2000/xmlns/'
# a namespace name libxml2 takes for a URI reference (RFC 3986): a
# scheme or no ':' before the first '/', '?' or '#', an authority after
# '//' (a numeric port), then the path, query and fragment characters;
# and the scheme that makes it absolute
_PCT = '%[0-9A-Fa-f]{2}'
_SUB = "A-Za-z0-9\\-._~!$&'()*+,;="
_URI = re.compile(
    r'(?:[A-Za-z][A-Za-z0-9+.\-]*:|(?![^/?#]*:))'
    r'(?://(?:(?:[{s}:]|{p})*@)?(?:\[[0-9A-Fa-f:.]+\]|(?:[{s}]|{p})*)'
    r'(?::[0-9]*)?(?=[/?#]|$)|(?!//))'
    r'(?:[{s}:@/]|{p})*(?:\?(?:[{s}:@/?]|{p})*)?(?:#(?:[{s}:@/?]|{p})*)?'
    .format(s=_SUB, p=_PCT))
_SCHEME = re.compile(r'[A-Za-z][A-Za-z0-9+.\-]*:')


class _XMLTreeBuilder:
    """Expat's events as an lxml tree, with libxml2's namespace rules.

    libxml2 recovers from a namespace error (an unbound prefix, a name
    with two colons, an empty or misplaced declaration, a namespace name
    that is not a URI) and keeps the name as written; lxml then raises
    when an error is the last message of the parse, so a later warning
    (a relative default namespace) lets the document through.
    ``last_error`` follows that."""

    def __init__(self):
        self.root = None
        self.stack = []
        self.scopes = [{'xml': _XML_NS}]
        self.last_error = None
        self.recovered = False
        self.root_end = None
        self.parser = self.source = None

    def _error(self, message):
        self.last_error = message
        self.recovered = True

    def xml_decl(self, version, encoding, standalone):
        if version is not None and not re.fullmatch(r'1\.[0-9]*', version):
            raise XMLSyntaxError('Unsupported version %r' % version)

    def skipped_entity(self, name, is_parameter_entity):
        self._error('Entity %r not defined' % name)

    def external_entity(self, context, base, system_id, public_id):
        # lxml loads no external entity
        raise XMLSyntaxError('Entity %r not defined' % context)

    def _split(self, qname):
        """(prefix, local part) of a QName; (None, qname) when it has
        no prefix or is not a QName."""
        prefix, colon, local = qname.partition(':')
        if not colon:
            return None, qname
        if not _NCNAME.match(prefix) or not _NCNAME.match(local):
            self._error('Failed to parse QName %r' % qname)
            return None, qname
        return prefix, local

    def _declare(self, scope, prefix, uri):
        if prefix is None:
            if uri in (_XML_NS, _XMLNS_NS):
                self._error('namespace %r cannot be the default' % uri)
                return
            if uri:
                if not _URI.fullmatch(uri):
                    self._error('xmlns: %r is not a valid URI' % uri)
                elif not _SCHEME.match(uri):
                    self.last_error = None    # the warning: not absolute
            scope[None] = uri or None
            return
        if prefix == 'xml':
            if uri != _XML_NS:
                self._error('xml namespace prefix mapped to wrong URI')
            return
        if prefix == 'xmlns' or uri in (_XML_NS, _XMLNS_NS) or not uri:
            self._error('xmlns:%s: %r cannot be declared' % (prefix, uri))
            return
        if not _URI.fullmatch(uri):
            self._error('xmlns:%s: %r is not a valid URI' % (prefix, uri))
        scope[prefix] = uri

    def start(self, name, attrs):
        scope = dict(self.scopes[-1])
        prefix, local = self._split(name)
        plain = []
        for key, value in attrs.items():
            if key == 'xmlns':
                self._declare(scope, None, value)
                continue
            aprefix, alocal = self._split(key)
            if aprefix == 'xmlns':
                self._declare(scope, alocal, value)
            else:
                plain.append((aprefix, alocal, key, value))
        attrib = {}
        for aprefix, alocal, key, value in plain:
            if aprefix is not None:
                uri = scope.get(aprefix)
                if uri is None:
                    self._error('Namespace prefix %s for %s on %s is not '
                                'defined' % (aprefix, alocal, local))
                else:
                    key = '{%s}%s' % (uri, alocal)
            if key in attrib:
                self._error('Namespaced Attribute %s redefined' % key)
                continue
            attrib[key] = value
        uri = scope.get(prefix)
        if uri is not None:
            name = '{%s}%s' % (uri, local)
        elif prefix is not None:
            self._error('Namespace prefix %s on %s is not defined'
                        % (prefix, local))
        el = _Element(name, attrib)
        if self.stack:
            self.stack[-1].append(el)
        elif self.root is None:
            self.root = el
        self.stack.append(el)
        self.scopes.append(scope)

    def end(self, name):
        self.stack.pop()
        self.scopes.pop()
        if not self.stack:
            m = _TAG.match(self.source, self.parser.CurrentByteIndex)
            self.root_end = m.end() if m else None

    def text(self, text):
        if self.stack:
            _append_text(self.stack[-1], text)

    def cdata(self):
        # an empty CDATA section still makes a text node
        self.text('')

    def comment(self, text):
        if self.stack:
            self.stack[-1].append(Comment(text))

    def pi(self, target, text):
        if self.stack:
            self.stack[-1].append(ProcessingInstruction(target, text))


# --- HTML: libxml2's tree rules ----------------------------------------

# open element -> the start tags that close it (htmlStartClose, read
# off lxml 6.1.1 / libxml2 2.14)
_CLOSED_BY = {
    'a': 'a fieldset table td th',
    'address': 'dd dl dt form li ul',
    'b': 'center p td th',
    'big': 'p',
    'caption': 'col colgroup tbody tfoot thead tr',
    'colgroup': 'colgroup tbody tfoot thead tr',
    'dd': 'dt',
    'dir': 'dd dl dt form ul',
    'dl': 'form li',
    'dt': 'dd dl',
    'font': 'center td th',
    'form': 'form',
    'h1': 'fieldset form li p table',
    'h2': 'fieldset form li p table',
    'h3': 'fieldset form li p table',
    'h4': 'fieldset form li p table',
    'h5': 'fieldset form li p table',
    'h6': 'fieldset form li p table',
    'head': 'a abbr acronym address b bdo big blockquote body br center '
            'cite code dd dfn dir div dl dt em fieldset font form frameset '
            'h1 h2 h3 h4 h5 h6 hr i iframe img kbd li listing map menu ol p '
            'pre q s samp small span strike strong sub sup table tt u ul '
            'var xmp',
    'i': 'center p td th',
    'legend': 'fieldset',
    'li': 'li',
    'listing': 'dd dl dt fieldset form li table ul',
    'menu': 'dd dl dt form ul',
    'ol': 'form',
    'option': 'optgroup option',
    'p': 'address blockquote body caption center col colgroup dd dir div dl '
         'dt fieldset form frameset h1 h2 h3 h4 h5 h6 head hr li listing '
         'menu ol p pre table tbody td tfoot th title tr ul xmp',
    'pre': 'dd dl dt fieldset form li table ul',
    's': 'p',
    'small': 'p',
    'span': 'td th',
    'strike': 'p',
    'tbody': 'tbody tfoot',
    'td': 'tbody td tfoot th tr',
    'tfoot': 'tbody',
    'th': 'tbody td tfoot th tr',
    'thead': 'tbody tfoot',
    'tr': 'tbody tfoot tr',
    'tt': 'p',
    'u': 'p td th',
    'ul': 'address form menu pre',
}
_CLOSED_BY = {k: frozenset(v.split()) for k, v in _CLOSED_BY.items()}

# an end tag closes the open elements above its own only while none of
# them has a higher priority (htmlEndPriority; 100 for the rest)
_END_PRIORITY = {'div': 150, 'td': 160, 'th': 160, 'tr': 170,
                 'thead': 180, 'tbody': 180, 'tfoot': 180, 'table': 190,
                 'head': 200, 'body': 200, 'html': 220}

_VOID = frozenset('area base basefont br col frame hr img input isindex '
                  'link meta param'.split())
_HEAD_CONTENT = frozenset('script style meta link title base'.split())
# a valueless attribute of these names takes its name as its value
_BOOLEAN_ATTRS = frozenset('checked compact declare defer disabled ismap '
                           'multiple nohref noresize noshade nowrap '
                           'readonly selected'.split())
_RAWTEXT = frozenset('style xmp iframe noembed noframes'.split())
_RCDATA = frozenset(('title', 'textarea'))
_WS = ' \t\n\x0c\r'


class _HTMLTreeBuilder:
    """libxml2's HTML tree construction over a stack of open elements."""

    def __init__(self):
        self.root = None
        self.stack = []
        self.seen = 0        # 3 once a head was opened, 10 once a body
        self.misplaced = 0   # html/head/body start tags dropped so far

    def _push(self, name, attrs=None):
        el = _Element(name, attrs)
        if self.stack:
            self.stack[-1].append(el)
        elif self.root is None:
            self.root = el
        # else: a second root after </html>, which the tree never shows
        self.stack.append(el)
        if name == 'head':
            self.seen = max(self.seen, 3)
        elif name == 'body':
            self.seen = 10

    def _auto_close(self, name):
        while self.stack and name in _CLOSED_BY.get(self.stack[-1].tag, ()):
            self.stack.pop()

    def _check_implied(self, name):
        if name == 'html':
            return
        if not self.stack:
            self._push('html')
        if name in ('body', 'head'):
            return
        if len(self.stack) <= 1 and name in _HEAD_CONTENT:
            if self.seen < 3:
                self._push('head')
        elif name not in ('noframes', 'frame', 'frameset'):
            if self.seen >= 10 or any(e.tag in ('body', 'head')
                                      for e in self.stack):
                return
            self._push('body')

    def start(self, name, attrs, self_closing):
        self._auto_close(name)
        self._check_implied(name)
        if attrs is None:
            return
        if (name == 'html' and self.stack) or \
                (name == 'head' and len(self.stack) != 1) or \
                (name == 'body' and any(e.tag == 'body' for e in self.stack)):
            self.misplaced += 1
            if self_closing and self.stack:
                # libxml2 ends the element that is open instead
                self.stack.pop()
            return
        self._push(name, attrs)
        if self_closing or name in _VOID:
            self.stack.pop()

    def end(self, name):
        if self.misplaced and name in ('html', 'body', 'head'):
            self.misplaced -= 1
            return
        priority = _END_PRIORITY.get(name, 100)
        for el in reversed(self.stack):
            if el.tag == name:
                break
            if _END_PRIORITY.get(el.tag, 100) > priority:
                return
        else:
            return
        while self.stack[-1].tag != name:
            self.stack.pop()
        self.stack.pop()

    def characters(self, text):
        if self.stack and text:
            _append_text(self.stack[-1], text)

    def data(self, text):
        if not self.stack or self.stack[-1].tag in ('html', 'head'):
            # leading whitespace stays where it is; other text opens
            # the body (htmlStartCharData)
            body = text.lstrip(_WS)
            self.characters(text[:len(text) - len(body)])
            if not body:
                return
            self._start_char_data()
            text = body
        self.characters(text)

    def _start_char_data(self):
        if self.stack and self.stack[-1].tag == 'head':
            self._auto_close('p')
        self._check_implied('p')

    def stray_lt(self, text):
        """A '<' (or '</' at the end) that starts no tag: text that
        opens the body wherever it stands."""
        self._start_char_data()
        self.characters(text)

    def comment(self, text):
        if self.stack:
            self.stack[-1].append(Comment(text))


# --- HTML: the tokenizer (HTML5 states, as libxml2 2.14 runs them) -------

# numeric references to C1 controls map through windows-1252
_C1 = dict(zip(
    [0x80, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x8b, 0x8c,
     0x8e, 0x91, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0x9b,
     0x9c, 0x9e, 0x9f],
    '\u20ac\u201a\u0192\u201e\u2026\u2020\u2021\u02c6\u2030\u0160\u2039'
    '\u0152\u017d\u2018\u2019\u201c\u201d\u2022\u2013\u2014\u02dc\u2122'
    '\u0161\u203a\u0153\u017e\u0178'))
_CHARREF = re.compile(r'&(?:#[xX]([0-9a-fA-F]+);?|#([0-9]+);?'
                      r'|([A-Za-z0-9]{1,32};?))')
_TAG_NAME = re.compile(r'[^\t\n\x0c />]*')
_ATTR_NAME = re.compile(r'[^\t\n\x0c />][^\t\n\x0c />=]*')
_UNQUOTED = re.compile(r'[^\t\n\x0c >]*')
_SKIP_WS = re.compile(r'[\t\n\x0c ]*')
_UPPER = str.maketrans('ABCDEFGHIJKLMNOPQRSTUVWXYZ',
                       'abcdefghijklmnopqrstuvwxyz')


def _replace_byte(exc):
    return '\ufffd', exc.start + 1


# each byte that is not part of a valid sequence becomes one U+FFFD
codecs.register_error('etree_compat.per_byte', _replace_byte)


def _unescape(text, in_attribute):
    """HTML5 character references in data or an attribute value."""
    if '&' not in text:
        return text

    def repl(m):
        hex_digits, dec_digits, name = m.groups()
        if name is None:
            num = int(hex_digits, 16) if hex_digits else int(dec_digits)
            if num == 0 or num > 0x10ffff or 0xd800 <= num <= 0xdfff:
                return '\ufffd'
            return _C1.get(num) or chr(num)
        # the longest name in the table; only the legacy names match
        # without their ';'
        for k in range(len(name), 1, -1):
            if name[:k] in _NAMED_REFS:
                break
        else:
            return m.group(0)
        if in_attribute and not name[:k].endswith(';'):
            after = name[k:k + 1] or text[m.end():m.end() + 1]
            if after == '=' or after.isalnum():
                return m.group(0)
        return _NAMED_REFS[name[:k]] + name[k:]
    return _CHARREF.sub(repl, text)


def _parse_attrs(s, i):
    """Attributes of the tag whose name ends at ``i``: (attrs,
    self_closing, index after '>'), or None at the end of the input."""
    attrs = {}
    n = len(s)
    while True:
        i = _SKIP_WS.match(s, i).end()
        if i >= n:
            return None
        c = s[i]
        if c == '>':
            return attrs, False, i + 1
        if c == '/':
            if s.startswith('>', i + 1):
                return attrs, True, i + 2
            i += 1
            continue
        m = _ATTR_NAME.match(s, i)
        name = m.group(0).translate(_UPPER)
        i = _SKIP_WS.match(s, m.end()).end()
        value = None
        if s.startswith('=', i):
            i = _SKIP_WS.match(s, i + 1).end()
            if i >= n:
                return None
            if s[i] in '"\'':
                end = s.find(s[i], i + 1)
                if end < 0:
                    return None
                value, i = s[i + 1:end], end + 1
            else:
                m = _UNQUOTED.match(s, i)
                value, i = m.group(0), m.end()
            value = _unescape(value, True)
        elif i >= n:
            return None
        if name not in attrs:
            if value is None:
                value = name if name in _BOOLEAN_ATTRS else ''
            attrs[name] = value


def _rawtext_end(s, i, name):
    """Index of the ``</name`` that ends raw text or RCDATA at ``i``."""
    pattern = re.compile(r'</%s[\t\n\x0c />]' % name, re.I)
    m = pattern.search(s, i)
    return m.start() if m else len(s)


def _script_end(s, i):
    """Index of the ``</script`` that ends the script data at ``i``,
    through HTML5's escaped and double-escaped script data states."""
    n = len(s)
    end_tag = re.compile(r'</script[\t\n\x0c />]', re.I)
    word = re.compile(r'[A-Za-z]*')
    state, dashes = 'data', 0
    while i < n:
        c = s[i]
        if state == 'data':
            if c == '<':
                if end_tag.match(s, i):
                    return i
                if s.startswith('<!--', i):
                    state, dashes, i = 'escaped', 2, i + 4
                    continue
            i += 1
            continue
        if c == '-':
            dashes += 1
            i += 1
            continue
        if c == '>' and dashes >= 2:
            state, dashes, i = 'data', 0, i + 1
            continue
        dashes = 0
        if c != '<':
            i += 1
        elif state == 'escaped' and end_tag.match(s, i):
            return i
        else:
            # <script or </script toggles the double-escaped state
            closing = s.startswith('</', i)
            w = word.match(s, i + (2 if closing else 1))
            if w.group(0).lower() == 'script' and w.end() < n and \
                    s[w.end()] in '\t\n\x0c />' and \
                    closing == (state == 'double'):
                state = 'escaped' if closing else 'double'
            i = max(w.end(), i + 1)
    return n


def _parse_html(data, encoding):
    if len(data) >= 4 and data.startswith(codecs.BOM_UTF8):
        # libxml2 sniffs a byte order mark only in 4 bytes or more
        data = data[3:]
    s = data.decode(encoding, 'etree_compat.per_byte')
    s = s.replace('\r\n', '\n').replace('\r', '\n').replace('\0', '\ufffd')
    b = _HTMLTreeBuilder()
    i, n = 0, len(s)
    while i < n:
        j = s.find('<', i)
        if j < 0:
            j = n
        if j > i:
            b.data(_unescape(s[i:j], False))
        i = j
        if i >= n:
            break
        c = s[i + 1:i + 2]
        if c.isascii() and c.isalpha():
            m = _TAG_NAME.match(s, i + 1)
            name = m.group(0).translate(_UPPER)
            parsed = _parse_attrs(s, m.end())
            if parsed is None:
                # cut off by the end of the input: the tag still closes
                # and implies what it would, and is then dropped
                b.start(name, None, None)
                break
            attrs, self_closing, i = parsed
            b.start(name, attrs, self_closing)
            if self_closing:
                continue
            if name == 'script':
                end = _script_end(s, i)
            elif name == 'plaintext':
                end = n
            elif name in _RAWTEXT or name in _RCDATA:
                end = _rawtext_end(s, i, name)
            else:
                continue
            text = s[i:end]
            b.characters(_unescape(text, False) if name in _RCDATA else text)
            i = end
        elif c == '/':
            c2 = s[i + 2:i + 3]
            if c2.isascii() and c2.isalpha():
                m = _TAG_NAME.match(s, i + 2)
                parsed = _parse_attrs(s, m.end())
                if parsed is None:
                    break
                i = parsed[2]
                b.end(m.group(0).translate(_UPPER))
            elif c2 == '>':
                i += 3
            elif not c2:
                b.stray_lt('</')
                break
            else:
                i = _bogus_comment(s, i + 2, b)
        elif c == '!':
            if s.startswith('<!--', i):
                i = _comment(s, i + 4, b)
            elif s[i + 2:i + 9].upper() == 'DOCTYPE':
                end = s.find('>', i)
                i = n if end < 0 else end + 1
            else:
                i = _bogus_comment(s, i + 2, b)
        elif c == '?':
            i = _bogus_comment(s, i + 1, b)
        else:
            b.stray_lt('<')
            i += 1
    return b.root


def _bogus_comment(s, i, b):
    end = s.find('>', i)
    if end < 0:
        end = len(s)
    b.comment(s[i:end])
    return end + 1


def _comment(s, i, b):
    """A comment whose ``<!--`` ends at ``i``; the index after it."""
    if s.startswith('>', i):
        b.comment('')
        return i + 1
    if s.startswith('->', i):
        b.comment('')
        return i + 2
    ends = [e for e in (s.find('-->', i), s.find('--!>', i)) if e >= 0]
    if not ends:
        # cut off by the end of the input: up to two dashes at the end
        # belong to the missing '-->'
        text = s[i:]
        for cut in ('--!', '--', '-'):
            if text.endswith(cut):
                text = text[:-len(cut)]
                break
        b.comment(text)
        return len(s)
    end = min(ends)
    b.comment(s[i:end])
    return end + (3 if s.startswith('-->', end) else 4)
