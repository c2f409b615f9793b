"""The part of ``lxml.etree`` that the port's copies of the JAX
package's ``cli/epub_to_pdf.py``, ``inputs/hocr.py`` and
``inputs/scandata.py`` call, on the standard library alone.

Each copy has its ``from lxml import etree`` pointed here
(``tools/copy_shared.py``), and machines without lxml run them.  So this
module builds the tree lxml builds, down to the nodes the copies look
at:

- ``fromstring(data)`` parses XML with expat, namespaces resolved as
  libxml2 resolves them (it recovers from a bad prefix or declaration,
  and lxml raises only when an error is the parse's last message).
  Comments and processing instructions stay in the tree as children
  whose ``tag`` is not a ``str`` (``Comment`` /
  ``ProcessingInstruction``), each with its own ``tail``; CDATA joins
  the text; no DTD default attribute is added and no external entity
  loaded; ``XMLSyntaxError`` is raised where lxml raises it.
  ``parse(path_or_file).getroot()`` is the same parser.
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
- ``iterparse(source, events=('end',), html=False, recover=True,
  huge_tree=True)``, the hOCR reader's call, streams libxml2's
  recovering XML parser as lxml runs it (``_IterParse``, ``_Recover``):
  the tree libxml2 builds from a document that is not well-formed, and
  the ``end`` events in lxml's order, which follows lxml's own stack of
  started elements, not libxml2's (a start tag with no end shifts every
  later event by one).  Well-formed input stays on expat.  Not followed:
  libxml2's recovery inside a broken XML declaration or DOCTYPE, and a
  namespace prefix declared twice in one tag whose first declaration is
  not a URI.
- Elements have ``tag``, ``text``, ``tail``, ``attrib``, ``get``,
  iteration, ``len``, indexing and ``del el[i]``, ``iter(tag)``
  (``'{*}name'`` matches any namespace), ``find``/``findall``,
  ``getparent()``, ``getprevious()``, ``clear()`` and an ``itertext()``
  that skips the text of comments and processing instructions but keeps
  their tails.  ``QName(el_or_tag).localname`` raises ``ValueError``
  where lxml does (comments, names that are not NCNames).

Nothing else of lxml is here.
"""

import codecs
import os
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

    def __len__(self):
        return len(self._children)

    def __getitem__(self, index):
        return self._children[index]

    def __delitem__(self, index):
        """Remove the child (with its tail) at ``index``."""
        doomed = self._children[index]
        del self._children[index]
        _unlink(doomed if isinstance(index, slice) else (doomed,))

    def clear(self):
        """Drop text, tail, attributes and children (as lxml)."""
        _unlink(self._children)
        self._children = []
        self.attrib = {}
        self.text = self.tail = None

    def getparent(self):
        return self._parent

    def getprevious(self):
        """The sibling before this node (an element, comment or
        processing instruction), or None."""
        parent = self._parent
        if parent is None:
            return None
        siblings = parent._children
        k = siblings.index(self)
        return siblings[k - 1] if k else None

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


def _unlink(nodes):
    """Detach ``nodes`` and their descendants from their parents: with
    no link up, a subtree that is dropped is freed at once, as lxml
    frees it, not at the garbage collector's next full pass (a detached
    node's ``getparent()`` is then None, where lxml would give its
    parent inside the dropped subtree)."""
    stack = list(nodes)
    while stack:
        node = stack.pop()
        node._parent = None
        stack.extend(node._children)


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
        el, scope = self._element(name, attrs, self.scopes[-1])
        if self.stack:
            self.stack[-1].append(el)
        elif self.root is None:
            self.root = el
        self.stack.append(el)
        self.scopes.append(scope)

    def _element(self, name, attrs, parent_scope):
        """The element of a start tag ``name`` with ``attrs`` (a dict of
        the names as written) under ``parent_scope``, and the namespace
        scope of its content."""
        if ':' not in name and not any(
                ':' in key or key.startswith('xmlns') for key in attrs):
            # no prefix and no declaration: the parent's scope
            uri = parent_scope.get(None)
            el = _Element('{%s}%s' % (uri, name) if uri else name)
            el.attrib = attrs
            return el, parent_scope
        scope = dict(parent_scope)
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
        return _Element(name, attrib), scope

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


# --- XML iterparse: libxml2's recovery ----------------------------------

def iterparse(source, events=('end',), html=False, recover=True,
              huge_tree=True):
    """``lxml.etree.iterparse`` as ``inputs/hocr.py`` calls it: the
    ``('end', element)`` events of ``source`` (a path or a binary file)
    and the tree that libxml2 2.14's recovering XML parser builds, in
    the order lxml reports them.  Only those argument values exist."""
    if tuple(events) != ('end',) or html is not False or \
            recover is not True or huge_tree is not True:
        raise TypeError("etree_compat.iterparse takes events=('end',), "
                        "html=False, recover=True, huge_tree=True only")
    return _IterParse(source)


_CHUNK = 32768        # what lxml's iterparse reads at a time
_START, _CONTENT, _EPILOG = range(3)
_BLANKS = ' \t\n\r'
_SKIP_BLANKS = re.compile('[ \t\n\r]*')
# a Name (XML 1.0 fifth edition): libxml2's QName parser takes the
# same characters and recovers the colons
_NAME = re.compile('[:%s][:%s.0-9\xb7\u0300-\u036f\u203f\u2040-]*'
                   % (_NAME_START, _NAME_START))
_PREDEFINED = {'lt': '<', 'gt': '>', 'amp': '&', 'apos': "'", 'quot': '"'}
# bytes that are not UTF-8 (decoded to U+DC80-U+DCFF by
# 'surrogateescape') become U+FFFD; C0 controls that are not XML
# characters leave text and become U+FFFD in attribute values
_BAD_BYTES = {c: '\ufffd' for c in range(0xdc80, 0xdd00)}
_CONTROL = [c for c in range(32) if c not in (9, 10, 13)]
_TEXT_FIX = {**_BAD_BYTES, **{c: None for c in _CONTROL}}
_ATTR_FIX = {**_BAD_BYTES, **{c: '\ufffd' for c in _CONTROL},
             9: ' ', 10: ' ', 13: ' '}
_NOT_TEXT = re.compile('[&<]')


def _is_char(c):
    return c in (9, 10, 13) or 0x20 <= c <= 0xd7ff or \
        0xe000 <= c <= 0xfffd or 0x10000 <= c <= 0x10ffff


class _IterParse:
    """The iterator ``iterparse`` returns.

    Two halves make the one reader.  Well-formed input goes through
    expat, fed ``_CHUNK`` bytes at a time; up to expat's first error the
    two parsers build the same tree.  At that error the bytes from the
    end of the last markup that expat reported (the text after it is
    held back until the next markup, so none of it is in the tree) go
    to ``_Recover``, which carries on from the open elements and their
    namespace scopes with libxml2's recovery rules.  Both halves report
    through ``_IterBuilder``, which keeps lxml's own stack of started
    elements beside the parser's."""

    def __init__(self, source):
        self._own = isinstance(source, (str, bytes, os.PathLike))
        self._fp = open(source, 'rb') if self._own else source
        self._builder = _IterBuilder()
        self._events = self._events_closing()

    @property
    def root(self):
        return self._builder.root

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._events)

    def _events_closing(self):
        try:
            yield from self._run()
        finally:
            if self._own:
                self._fp.close()

    def _run(self):
        b, fp = self._builder, self._fp
        events = b.events
        p = _expat.ParserCreate()
        p.buffer_text = True
        p.specified_attributes = True
        pending = []            # text since the last markup
        # the last markup: its stream offset and what ends it (b'<' a
        # start tag, b'>' an end tag, b'/' an end right after its start,
        # whose offset is third, as expat gives an empty-element tag's
        # end the offset after it; b'-->', b'?>', b']]>'); None for a
        # CDATA section that is still open and b'' for held text that
        # went into the tree, both taken back from that offset
        last = [None, None, None]

        open_, nodes = b.open, b.nodes

        def commit():
            text = pending[0] if len(pending) == 1 else ''.join(pending)
            pending.clear()
            if open_:
                _append_text(open_[-1][0], text)

        tags = {}           # (namespace, name) -> tag

        def start(name, attrs):
            # _IterBuilder.start_element, inline: expat's half of a big
            # book is one call of this a tag
            if open_:
                parent, _, scope = open_[-1]
                if pending:
                    _append_text(parent, ''.join(pending))
                    pending.clear()
            else:
                parent, scope = None, _IterBuilder._ROOT_SCOPE
                pending.clear()
            last[0] = p.CurrentByteIndex
            last[1] = b'<'
            keys = ''.join(attrs)
            if ':' in name or ':' in keys or 'xmlns' in keys:
                el, scope = b._element(name, attrs, scope)
            else:
                key = scope.get(None), name
                tag = tags.get(key)
                if tag is None:
                    tag = tags[key] = '{%s}%s' % key if key[0] else name
                el = _Element(tag)
                el.attrib = attrs
            if parent is not None:
                el._parent = parent
                parent._children.append(el)
            elif b.root is None:
                b.root = el
            nodes.append(el)
            open_.append((el, name, scope))

        def end(name):
            if pending:
                _append_text(open_[-1][0], ''.join(pending))
                pending.clear()
            if last[1] == b'<':
                last[1] = b'/'
                last[2] = last[0]
            else:
                last[1] = b'>'
            last[0] = p.CurrentByteIndex
            open_.pop()
            events.append(('end', nodes.pop()))

        def comment(text):
            if pending:
                commit()
            last[:] = p.CurrentByteIndex, b'-->', None
            b.comment(text)

        def pi(target, text):
            if pending:
                commit()
            last[:] = p.CurrentByteIndex, b'?>', None
            b.pi(target, text)

        def cdata_start():
            if pending:
                commit()
            # an error inside the section takes it back whole
            last[:] = p.CurrentByteIndex, None, None
            pending.append('')

        def cdata_end():
            commit()
            last[:] = p.CurrentByteIndex, b']]>', None

        p.StartElementHandler = start
        p.EndElementHandler = end
        p.CharacterDataHandler = pending.append
        p.CommentHandler = comment
        p.ProcessingInstructionHandler = pi
        p.StartCdataSectionHandler = cdata_start
        p.EndCdataSectionHandler = cdata_end
        # an undefined entity (skipped by expat when there is a DTD) and
        # an external one are dropped, as libxml2 drops them
        p.ExternalEntityRefHandler = lambda *args: 1
        standalone = []

        def xml_decl(version, encoding, flag):
            standalone.append(flag == 1)

        def doctype(name, system_id, public_id, internal):
            b.external_dtd = (system_id is not None or public_id is not None
                              ) and not any(standalone)

        def entity(name, parameter, value, base, system_id, public_id,
                   notation):
            if not parameter:
                b.entities.setdefault(name, value or '')

        p.XmlDeclHandler = xml_decl
        p.StartDoctypeDeclHandler = doctype
        p.EntityDeclHandler = entity
        buf, at = bytearray(), 0      # the bytes from stream offset ``at``
        encoding = None
        while True:
            data = fp.read(_CHUNK)
            if encoding is None:
                if not data:
                    raise XMLSyntaxError('no element found')
                encoding = _declared_encoding(data)
            buf += data
            try:
                p.Parse(data, not data)
            except _expat.ExpatError:
                break
            if pending and last[1] is not None:
                # text that a '<' ends is in libxml2's tree before the
                # next read; expat holds it back, so it goes in here (a
                # CDATA section's text waits for its end)
                k = buf.find(b'<', _resume_at(buf, at, last) - at)
                if k >= 0:
                    commit()
                    last[:] = k + at, b'', None
            if events:
                yield from events
                events.clear()
            if not data:
                return
            keep = last[2] if last[1] == b'/' else last[0]
            if keep is not None and keep > at:
                del buf[:keep - at]
                at = keep
        # expat's first error: libxml2's recovery from the end of the
        # last markup expat reported (or the start of the document)
        restart = _resume_at(buf, at, last)
        reader = _Reader(fp, bytes(buf[restart - at:]), encoding)
        del buf
        state = _CONTENT if b.open else _EPILOG if b.root is not None \
            else _START
        yield from _Recover(b, reader.read(), reader.read, state).run()


def _declared_encoding(data):
    """The codec of the document's XML declaration; 'utf-8' without one
    or for one Python does not know."""
    m = _ENCODING_DECL.match(data)
    if m:
        try:
            return codecs.lookup(m.group(3).decode('ascii')).name
        except LookupError:
            pass
    return 'utf-8'


def _resume_at(buf, at, last):
    """The stream offset just after the last markup expat reported
    (``last``, see ``_IterParse._run``); ``buf`` holds the bytes from
    offset ``at`` on."""
    offset, kind, start_offset = last
    if offset is None:
        # the start of the document, after its XML declaration
        start = 3 if buf.startswith(codecs.BOM_UTF8) else 0
        m = _XML_DECL.match(buf, start)
        return m.end() if m else start
    if not kind:
        return offset
    if kind == b'/' and buf.endswith(b'/>', 0, offset - at) and \
            _TAG_END.match(buf, start_offset - at).end() + at == offset:
        return offset                   # an empty-element tag
    if kind in (b'<', b'/', b'>'):
        return _TAG_END.match(buf, offset - at).end() + at
    # past '<!--' or '<?' ('<!-->' holds a '-->')
    skip = {b'-->': 4, b'?>': 2}.get(kind, 0)
    return buf.index(kind, offset - at + skip) + len(kind) + at


class _Reader:
    """The text of the rest of the input, ``_CHUNK`` bytes a read, with
    libxml2's handling of bytes that are not UTF-8: each becomes U+FFFD
    ('surrogateescape' marks it, ``_BAD_BYTES`` replaces it), except
    that a sequence the end of the input cuts short is dropped."""

    def __init__(self, fp, first, encoding):
        self.fp = fp
        self.first = first
        self.utf8 = encoding == 'utf-8'
        self.decoder = codecs.getincrementaldecoder(encoding)(
            'surrogateescape')
        self.held = b''

    def read(self):
        while True:
            if self.first is not None:
                data, self.first = self.first, None
            else:
                data = self.fp.read(_CHUNK)
            if not data:
                if not self.utf8:
                    return self.decoder.decode(b'', True)
                rest = self.decoder.getstate()[0] + self.held
                self.decoder.reset()
                self.held = b''
                return _utf8_end(rest)
            if not self.utf8:
                text = self.decoder.decode(data)
            else:
                data = self.held + data
                self.held = data[-3:]
                text = self.decoder.decode(data[:-3])
            if text:
                return text


def _utf8_end(data):
    """The last bytes of the input as libxml2 reads them: a sequence
    that needs more bytes than are left is dropped a byte at a time."""
    out = []
    i, n = 0, len(data)
    while i < n:
        c = data[i]
        if c < 0x80:
            out.append(chr(c))
            i += 1
            continue
        need = 2 if c < 0xe0 else 3 if c < 0xf0 else 4
        for k in range(1, need):
            if n - i <= k:
                need = 0                # incomplete: dropped
                break
            if data[i + k] & 0xc0 != 0x80:
                need = -1
                break
        if need > 0:
            try:
                out.append(data[i:i + need].decode('utf-8'))
                i += need
                continue
            except UnicodeDecodeError:
                need = -1
        if need < 0:
            out.append(chr(0xdc00 + c))   # U+FFFD in the tree
        i += 1
    return ''.join(out)


_XML_DECL = re.compile(rb'<\?xml[ \t\r\n](?:[^?]|\?(?!>))*\?>')
# a start or end tag that expat read, up to its '>'
_TAG_END = re.compile(rb'<(?:[^>"\']|"[^"]*"|\'[^\']*\')*>')


class _IterBuilder(_XMLTreeBuilder):
    """The tree and the events of ``iterparse``.

    ``open`` is the parser's stack of open elements (element, name as
    written, namespace scope); ``nodes`` is lxml's stack of started
    elements.  libxml2 starts an element before it has read the end of
    its start tag, and drops it from its own stack without ending it
    when the tag has no end; lxml's stack keeps it.  An end event pops
    lxml's stack, so from then on each end reports the element started
    one before it, and at the end of the input lxml ends whatever its
    stack still holds."""

    _ROOT_SCOPE = {'xml': _XML_NS}

    def __init__(self):
        super().__init__()
        self.open = []
        self.nodes = []
        self.events = []
        self.entities = {}          # the DTD's general entities
        self.external_dtd = False   # an undeclared entity is no error
        self.doctype_read = False   # a second DOCTYPE stops the parser

    def start_element(self, name, attrs):
        """A started element: in the tree and on lxml's stack."""
        parent = self.open[-1] if self.open else None
        el, scope = self._element(name, attrs, parent[2] if parent
                                  else self._ROOT_SCOPE)
        if parent is not None:
            parent[0].append(el)
        elif self.root is None:
            self.root = el
        self.nodes.append(el)
        return el, scope

    def end_element(self):
        self.open.pop()
        self.events.append(('end', self.nodes.pop()))

    def end_started(self):
        self.events.append(('end', self.nodes.pop()))

    def flush(self):
        while self.nodes:
            self.events.append(('end', self.nodes.pop()))

    def text(self, text):
        if text:
            _append_text(self.open[-1][0], text)

    def comment(self, text):
        if self.open:
            self.open[-1][0].append(Comment(text))

    def pi(self, target, text):
        if self.open:
            self.open[-1][0].append(ProcessingInstruction(target, text))


class _NeedMore(Exception):
    """A construct of the input does not end in the buffer yet."""


class _Recover:
    """libxml2 2.14's push parser in recovery mode, from the state expat
    left (``lxml.etree.iterparse(..., recover=True)`` feeds libxml2 this
    way).  Each construct is read once its end is in the buffer, as the
    push parser waits for it: a start tag up to a '>' outside quotes, a
    reference up to a ';', an end tag up to a '>'.  The rules, read off
    lxml 6.1.1 (libxml2 2.14.6):

    - a start tag whose name does not start right after '<' (also '<!'
      that opens no comment or CDATA section), and anything but a
      comment, a processing instruction or blanks after the root
      element, stop the parser;
    - an attribute with no '=' or no quoted value is dropped; an
      attribute name that cannot be read, or no blank before the next
      attribute, ends the tag there: the element is started (lxml's
      stack) but not opened unless a '>' (or '/>') follows, and the rest
      is text;
    - an end tag closes the open element whatever its name; what follows
      its name other than blanks and '>' is text;
    - '&' without a name is dropped; '&name' without ';' and an entity
      that is not declared are dropped with their name; a character
      reference stops at its first bad digit (the digits are dropped)
      and gives nothing when its value is not a character, U+FFFD above
      U+10FFFF; in an attribute value such a reference drops the
      attribute;
    - once an error has been met (``wf`` false: any error but a
      namespace one, or an undeclared entity in a document with an
      external DTD), an entity reference in text gives nothing, a
      predefined one too; character references and attribute values
      are not affected;
    - '<' in an attribute value is kept; a byte that is not UTF-8
      becomes U+FFFD; a C0 control leaves text;
    - a comment, processing instruction or CDATA section that does not
      end, or holds a C0 control, is dropped (the text goes on at the
      control); '<?' with no target is text; ']]>' in text loses what
      precedes it (``_char_data``);
    - at the end of the input every element on lxml's stack ends."""

    def __init__(self, builder, text, read, state):
        self.b = builder
        self.s = text
        self.i = 0
        self.read = read
        self.eof = False
        self.state = state
        self.halted = False
        self.wf = True      # no error met yet (expat's is met again here)
        self._scan = None   # (construct start, resume index, quote)

    def _error(self):
        self.wf = False

    def _halt(self):
        self.wf = False
        self.halted = True

    def _find(self, sub, start):
        """Index of ``sub`` at or after ``start``; -1 at the end of the
        input."""
        k = self.s.find(sub, start)
        if k < 0 and not self.eof:
            raise _NeedMore
        return k

    def _ensure(self, n):
        if len(self.s) < self.i + n and not self.eof:
            raise _NeedMore

    def _lookup_gt(self):
        """Wait for the first '>' outside quotes after ``i``."""
        s, i = self.s, self.i
        k, quote = i + 1, None
        if self._scan is not None and self._scan[0] == i:
            k, quote = self._scan[1:]
        n = len(s)
        while k < n:
            c = s[k]
            if quote:
                k = s.find(quote, k)
                if k < 0:
                    k = n
                    break
                quote = None
            elif c in '"\'':
                quote = c
            elif c == '>':
                self._scan = None
                return
            k += 1
        if not self.eof:
            self._scan = (i, k, quote)
            raise _NeedMore
        self._scan = None

    def run(self):
        """The events, handed over whenever a read of ``_CHUNK`` bytes
        is due (lxml's feed loop) and at the end."""
        b = self.b
        step = {_START: self._start, _CONTENT: self._content,
                _EPILOG: self._epilog}
        while not self.halted:
            if self.i > 65536:
                if self._scan is not None:
                    self._scan = (0, self._scan[1] - self.i, self._scan[2])
                self.s, self.i = self.s[self.i:], 0
            try:
                if self.i >= len(self.s):
                    if self.eof:
                        break
                    raise _NeedMore
                step[self.state]()
            except _NeedMore:
                if b.events:
                    yield from b.events
                    b.events.clear()
                text = self.read()
                if text:
                    self.s += text
                else:
                    self.eof = True
        b.flush()
        yield from b.events
        b.events.clear()

    def _skip(self, i):
        return _SKIP_BLANKS.match(self.s, i).end()

    def _chars(self, text, fix=_TEXT_FIX):
        """``text`` as libxml2 keeps it; a character that is not XML's is
        an error."""
        if '\r' in text:
            text = text.replace('\r\n', '\n').replace('\r', '\n')
        if _NOT_XML.search(text):
            self._error()
        return text.translate(fix)

    # -- content

    def _content(self):
        s, i = self.s, self.i
        c = s[i]
        if c == '<':
            self._ensure(2)
            nxt = self.s[i + 1:i + 2]
            if nxt == '/':
                self._end_tag()
            elif nxt == '?':
                self._pi()
            elif nxt == '!':
                self._ensure(9)
                if self.s.startswith('<!--', i):
                    self._comment()
                elif self.s.startswith('<![CDATA[', i):
                    self._cdata()
                else:
                    self._start_tag()
            else:
                self._start_tag()
        elif c == '&':
            self._find(';', i)
            self._reference()
        else:
            m = _NOT_TEXT.search(s, i)
            j = m.start() if m else len(s)
            if not m and not self.eof:
                # the push parser waits for the end of a short run
                if j - i < 300:
                    raise _NeedMore
                if s.endswith('\r'):
                    j -= 1          # a CR LF pair may be split
            self.b.text(self._char_data(s[i:j]))
            self.i = j

    def _char_data(self, text):
        """A run of text as libxml2 keeps it.  ']]>' is an error; where
        only ASCII (tabs and line ends included) comes before it since the
        run's start or a C0 control, libxml2's fast path drops what it has
        not handed over yet (back to that start or the last CR LF) with
        the first ']'."""
        if ']]>' in text:
            self._error()
            text = ''.join(_fast_path_cut(part)
                           for part in _CONTROL_SPLIT.split(text))
        return self._chars(text)

    def _start_tag(self):
        self._lookup_gt()
        s, n = self.s, len(self.s)
        m = _NAME.match(s, self.i + 1)
        if not m:
            self._halt()                # StartTag: invalid element name
            return
        name = m.group(0)
        i = self._skip(m.end())
        attrs = {}
        while i < n:
            c = s[i]
            if c == '>' or (c == '/' and s.startswith('>', i + 1)) or \
                    (c < ' ' and c not in '\t\n\r'):
                break
            m = _NAME.match(s, i)
            if not m:
                self._error()           # error parsing attribute name
                break
            i = self._skip(m.end())
            if s.startswith('=', i):
                value, i = self._att_value(self._skip(i + 1))
                if value is not None:
                    if m.group(0) in attrs:
                        self._error()   # Attribute redefined
                    else:
                        attrs[m.group(0)] = value
            else:
                self._error()           # a value is mandatory
            if s.startswith('>', i) or s.startswith('/>', i):
                break
            j = self._skip(i)
            if j == i:
                self._error()           # attributes construct error
                break
            i = j
        b = self.b
        el, scope = b.start_element(name, attrs)
        if s.startswith('/>', i):
            b.end_started()
            i += 2
        elif s.startswith('>', i):
            b.open.append((el, name, scope))
            i += 1
        else:
            self._error()   # no end of the start tag: started, not opened
        self.i = i
        self.state = _CONTENT if b.open else _EPILOG

    def _att_value(self, i):
        """(value or None, index after it) of the quoted value at i."""
        s = self.s
        quote = s[i:i + 1]
        if quote not in ('"', "'"):
            self._error()
            return None, i
        run = _ATT_RUN[quote]
        out = []
        i += 1
        n = len(s)
        while True:
            k = run.match(s, i).end()
            out.append(s[i:k])
            i = k
            if i >= n:
                self._error()
                return None, i
            if s[i] == quote:
                value = ''.join(out)
                if '<' in value:
                    self._error()
                return self._chars(value, _ATTR_FIX), i + 1
            if s.startswith('&#', i):
                value, i = self._char_ref(i)
                if not value:
                    return None, i
                out.append(value)
            else:
                name, i = self._entity_name(i)
                if name is not None:
                    out.append(self._entity_text(name))

    def _char_ref(self, i):
        """(the character or '', index after) of '&#...' at i."""
        s = self.s
        if s.startswith('&#x', i):
            i, base, digits = i + 3, 16, '0123456789abcdefABCDEF'
        else:
            i, base, digits = i + 2, 10, '0123456789'
        val = 0
        while i < len(s) and s[i] != ';':
            if s[i] not in digits:
                val = 0
                break
            val = min(val * base + int(s[i], 16), 0x110000)
            i += 1
        if s.startswith(';', i):
            i += 1
        if val >= 0x110000:
            self._error()
            return '\ufffd', i
        if _is_char(val):
            return chr(val), i
        self._error()
        return '', i

    def _entity_name(self, i):
        """(the name or None, index after) of the entity reference at i."""
        s = self.s
        m = _NAME.match(s, i + 1)
        if not m:
            self._error()               # xmlParseEntityRef: no name
            return None, i + 1
        i = m.end()
        if not s.startswith(';', i):
            self._error()               # EntityRef: expecting ';'
            return None, i
        return m.group(0), i + 1

    def _entity_text(self, name, depth=0):
        """The replacement text of a predefined or declared entity; ''
        for one that is not declared (an error unless the document has
        an external DTD)."""
        text = _PREDEFINED.get(name)
        if text is not None:
            return text
        value = self.b.entities.get(name)
        if value is None:
            if not self.b.external_dtd:
                self._error()
            return ''
        if '&' in value and depth < 8:
            value = re.sub(r'&([^;&]*);', lambda m: self._entity_text(
                m.group(1), depth + 1), value)
        return value

    def _reference(self):
        if self.s.startswith('&#', self.i):
            text, self.i = self._char_ref(self.i)
        else:
            name, self.i = self._entity_name(self.i)
            if name is None:
                return
            text = self._entity_text(name)
            if not self.wf:
                return
        self.b.text(text)

    def _end_tag(self):
        self._find('>', self.i)
        s, i = self.s, self.i + 2
        b = self.b
        name = b.open[-1][1]
        k = i + len(name)
        if s.startswith(name, i) and k < len(s) and s[k] in '>' + _BLANKS:
            i = k
        else:
            m = _NAME.match(s, i)
            if not m or m.group(0) != name:
                self._error()           # Opening and ending tag mismatch
            if m:
                i = m.end()
        i = self._skip(i)
        if s.startswith('>', i):
            i += 1
        else:
            self._error()
        b.end_element()
        self.i = i
        self.state = _CONTENT if b.open else _EPILOG

    def _pi(self):
        i = self.i
        k = self._find('?>', i + 2)
        s = self.s
        m = _NAME.match(s, i + 2)
        if not m:
            # xmlParsePI : no target name; the '<?' is dropped
            self._error()
            self.i = i + 2
            return
        if self._cut_at_control(m.end(), k):
            return
        if k < 0:
            self._error()               # PI never ends
            self.i = len(s)
            return
        target = m.group(0)
        if target.lower() == 'xml' or (
                k > m.end() and s[m.end()] not in _BLANKS):
            self._error()   # a declaration here, or no blank after it
        self.b.pi(target, self._chars(s[self._skip(m.end()):k]))
        self.i = k + 2

    def _comment(self):
        k = self._find('-->', self.i + 4)
        s = self.s
        if self._cut_at_control(self.i + 4, k):
            return
        if k < 0:
            self._error()               # Comment not terminated
            self.i = len(s)
            return
        text = s[self.i + 4:k]
        if '--' in text:
            self._error()
        self.b.comment(self._chars(text))
        self.i = k + 3

    def _cdata(self):
        k = self._find(']]>', self.i + 9)
        s = self.s
        if self._cut_at_control(self.i + 9, k):
            return
        if k < 0:
            self._error()               # CData section not finished
            self.i = len(s)
            return
        _append_text(self.b.open[-1][0], self._chars(s[self.i + 9:k]))
        self.i = k + 3

    def _cut_at_control(self, start, end):
        """A C0 control in a comment, PI or CDATA section (between
        ``start`` and ``end``, -1 for the end of the input) drops it;
        the text goes on at the control."""
        m = _C0.search(self.s, start, len(self.s) if end < 0 else end)
        if m is None:
            return False
        self._error()
        self.i = m.start()
        return True

    # -- around the root element

    def _misc(self):
        """A comment, a processing instruction or blanks at ``i``; False
        for anything else."""
        i = self._skip(self.i)
        if i > self.i:
            self.i = i
            return True
        self._ensure(4)
        if self.s.startswith('<?', i):
            self._pi()
            return True
        if self.s.startswith('<!--', i):
            self._comment()
            return True
        return False

    def _start(self):
        if self._misc():
            return
        self._ensure(9)
        s, i = self.s, self.i
        if s.startswith('<!DOCTYPE', i) and not self.b.doctype_read:
            self._doctype()
        elif s.startswith('<', i):
            self._start_tag()
        else:
            self._halt()                # Start tag expected

    def _doctype(self):
        """Skips a document type declaration (its internal subset to the
        first ']')."""
        self._lookup_gt()
        self.i = _DOCTYPE.match(self.s, self.i).end()
        self.b.doctype_read = True

    def _epilog(self):
        if not self._misc():
            self._halt()                # Extra content at the end


_ATT_RUN = {q: re.compile('[^&%s]*' % q) for q in '"\''}
# what takes libxml2's text parser off its ASCII fast path, and the C0
# controls that end its slow path (the next text starts on the fast one)
_SLOW_PATH = re.compile('[^\t\n\r\x20-\x7f]|\r(?!\n)')
_C0 = re.compile('[\x00-\x08\x0b\x0c\x0e-\x1f]')
_CONTROL_SPLIT = re.compile('([\x00-\x08\x0b\x0c\x0e-\x1f])')


def _fast_path_cut(text):
    """``text`` (a run with no C0 control) less what libxml2's fast path
    drops at each ']]>' it meets."""
    kept = []
    while True:
        k = text.find(']]>')
        if k < 0 or _SLOW_PATH.search(text, 0, k):
            break
        crlf = text.rfind('\r\n', 0, k)
        if crlf >= 0:
            kept.append(text[:crlf])
        text = text[k + 1:]
    return ''.join(kept) + text
# what is not an XML character (C0 controls, bytes that are not UTF-8)
_NOT_XML = re.compile('[\x00-\x08\x0b\x0c\x0e-\x1f\udc80-\udcff]')
_DOCTYPE = re.compile(r'<!DOCTYPE(?:[^>\[\'"]|"[^"]*"|\'[^\']*\')*'
                      r'(?:\[[^\]]*\][ \t\n\r]*)?>?')


# an XML document as lxml.etree.parse reads it (no recovery)

class _ElementTree:
    def __init__(self, root):
        self._root = root

    def getroot(self):
        return self._root


def parse(source):
    """``lxml.etree.parse(source)`` (a path or a binary file): the tree
    of a well-formed document; ``XMLSyntaxError`` otherwise."""
    if isinstance(source, (str, bytes, os.PathLike)):
        with open(source, 'rb') as fp:
            data = fp.read()
    else:
        data = source.read()
    return _ElementTree(fromstring(data))


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
