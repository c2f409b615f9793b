"""The port's ``utils/etree_compat.py`` held against lxml, the parser the
JAX package's epub-to-pdf uses.

Each case parses the same bytes with both, as XML (``fromstring``) or
through the recovering HTML parser (``fromstring(data, HTMLParser(
encoding='utf-8'))``), and compares a dump of the two trees: every node
in document order with its kind or tag, text, tail, sorted attributes,
the position of its parent (``getparent()``) and its ``itertext()``.
Where lxml raises ``XMLSyntaxError`` the port must raise it too, and
where lxml returns no tree (an HTML document with no element) so must
the port.  Beside the hand-written cases, seeded generated documents
(tag soup for HTML, mutated well-formed documents for XML) and the
libxml2 tables the HTML parser copies (auto-close on a start tag, end-tag
priorities) are read off lxml and compared.

These tests need lxml, which the JAX package needs too; nothing here
runs torch.
"""

import random

import pytest

lxml_etree = pytest.importorskip('lxml.etree')

from archive_pdf_tools_tpu_torch.utils import etree_compat  # noqa: E402


def _dump(root, mod):
    if root is None:
        return None
    nodes = list(root.iter())
    index = {id(n): k for k, n in enumerate(nodes)}
    out = []
    for n in nodes:
        if isinstance(n.tag, str):
            kind, attrs = n.tag, sorted(n.attrib.items())
            text = list(n.itertext())
        else:
            kind = 'comment' if n.tag is mod.Comment else 'pi'
            attrs = text = None
        parent = n.getparent()
        out.append((kind, n.text, n.tail, attrs,
                    None if parent is None else index[id(parent)], text))
    return out


def _parse(mod, data, html):
    try:
        if html:
            root = mod.fromstring(data, mod.HTMLParser(encoding='utf-8'))
        else:
            root = mod.fromstring(data)
    except mod.XMLSyntaxError:
        return 'XMLSyntaxError'
    return _dump(root, mod)


def _same(data, html):
    assert _parse(etree_compat, data, html) == \
        _parse(lxml_etree, data, html), data


XML_CASES = {
    'comments_pis_cdata': b'<?xml version="1.0"?><!-- top --><r>a&amp;b'
                          b'<!-- c -->d<?pi x?>e<![CDATA[f<g]]>h<p>i<!--'
                          b' j --></p></r><!-- end --><?pi z?>',
    'empty_cdata': b'<r><a/><![CDATA[]]><![CDATA[]]></r>',
    'namespaces': b'<r xmlns="u:d" xmlns:e="u:e"><e:a e:b="1" c="2">t'
                  b'</e:a><b xml:lang="fr" xmlns="">x</b></r>',
    'xml_lang_space': b'<r xml:lang="en" xml:space="preserve"> </r>',
    'entities': b'<!DOCTYPE r [<!ENTITY e "ent&#38;amp;"><!ENTITY m '
                b'"<b>x</b>">]><r a="&e;">&e;&m;&lt;&gt;&apos;&quot;'
                b'&#65;&#x263a;</r>',
    'attlist_default': b'<!DOCTYPE r [<!ATTLIST r a CDATA "d">]><r/>',
    'bom': b'\xef\xbb\xbf<r>bom</r>',
    'latin1': '<?xml version="1.0" encoding="iso-8859-1"?><r>\xe9</r>'
              .encode('latin-1'),
    'cp1252': '<?xml version="1.0" encoding="windows-1252"?><r>\x80</r>'
              .encode('latin-1'),
    'utf8_spelling': b'<?xml version="1.0" encoding="UTF8"?><r>\xc3\xa9</r>',
    'utf16': '<?xml version="1.0" encoding="utf-16"?><r>u</r>'
             .encode('utf-16'),
    'shift_jis': '<?xml version="1.0" encoding="Shift_JIS"?><r a="\u65e5">'
                 '\u65e5\u672c\u8a9e</r>'.encode('shift_jis'),
    'line_ends': b'<r a="x\ny\tz&#10;">\r\n a \r b</r>',
    'relative_default_namespace': b'<r p:a="1"><c xmlns="u"/></r>',
    'undefined_entity': b'<r>&nbsp;</r>',
    'xhtml_nbsp': b'<!DOCTYPE html PUBLIC "-//W3C//DTD XHTML 1.1//EN" '
                  b'"http://www.w3.org/TR/xhtml11/DTD/xhtml11.dtd"><html '
                  b'xmlns="http://www.w3.org/1999/xhtml"><body><p>a&nbsp;b'
                  b'</p></body></html>',
    'external_entity': b'<!DOCTYPE r [<!ENTITY e SYSTEM "x.ent">]><r>&e;'
                       b'</r>',
    'duplicate_attribute': b'<r a="1" a="2"/>',
    'unbound_prefix': b'<r><x:y k="1" p:a="2"/></r>',
    'bad_namespace_uri': b'<r xmlns:x="a b"/>',
    'junk_after_root': b'<r/><s/>',
    'mismatched_tag': b'<r></s>',
    'unclosed': b'<r>',
    'empty': b'',
    'bad_version': b'<?xml version="2.0"?><r/>',
    'bad_encoding': b'<?xml version="1.0" encoding="bogus"?><r/>',
}

HTML_CASES = {
    'implied_and_autoclose': b'<p>one<br>two<p>three &amp; &nbsp;x<table>'
                             b'<tr><td>c</table>',
    'xhtml_with_nbsp': b'<?xml version="1.0" encoding="utf-8"?>\n<!DOCTYPE '
                       b'html>\n<html xmlns="http://www.w3.org/1999/xhtml">'
                       b'\n<head>\n<title>T</title>\n</head>\n<body>\n<p>'
                       b'a&nbsp;b</p>\n</body>\n</html>\n',
    'whitespace_head_body': b' \n<html>\n <head> <title>T</title> </head>\n'
                            b' <body>\n <p>a</p>\n <p>b</p> \n</body>\n'
                            b'</html>\n',
    'unclosed_li_dt_dd': b'<ul><li>a<li>b<ul><li>c</ul><li>d</ul><dl><dt>'
                         b'x<dd>y<dt>z</dl>',
    'unclosed_cells': b'<table><tr><th>h<td>a<td>b<tr><td>c</table>after',
    'upper_case_unquoted': b'<P CLASS=x ID=y>Up<BR>case<IMG SRC=a.png '
                           b'ALT=b>',
    'bare_amp_and_voids': b'a & b <img src=x.png> c<br/>d<hr>e<input '
                          b'disabled>',
    'script_style': b'<script>if (a < b && c) x("</p>");</script><style>'
                    b'p > a { }</style><p>z',
    'script_escapes': b'<script><!-- <script> </script> --></script>z',
    'raw_and_rcdata': b'<title>a&amp;<b></title><textarea>x&lt;y'
                      b'</textarea><xmp>a&amp;<b></xmp><p>q',
    'comments_pis_cdata': b'<p>a<?pi x?>b<![CDATA[c<d]]>e<!-- f -->g'
                          b'<!--->h<!-- i --!>j',
    'entities': b'<p title="&copy=x &copy &notin;">&amp &lt; &copy '
                b'&notit; &#128; &#x41; &#0; &#1; &bogus; &</p>',
    'misplaced_html_head_body': b'<html><p>a</p><html lang=en><head>'
                                b'<title>t</title><body><body class=x>'
                                b'b</body>c',
    'after_body_and_html': b'<html><body><p>a</p></body><p>b</p>tail'
                           b'</html><p>dropped',
    'end_tag_priority': b'<div><span>a</div>b<table><tr><td><div>c</td>'
                        b'</tr></table><p>x</b>y</p>',
    'self_closing': b'<br/>a<p/>b<div/>c<script/>d<head/>e',
    'head_content': b'<meta charset=utf-8><link rel=x><style>s</style>'
                    b'<p>x<meta name=a>',
    'text_in_head': b'<head> <title>t</title> abc<p>d',
    'frameset': b'<frameset><frame src=a><noframes>n</noframes>'
                b'</frameset><',
    'bom_and_bad_utf8': b'\xef\xbb\xbf<p>\xe2\x82x\xc3\xa9\xff\x00</p>',
    'lone_bom': b'\xef\xbb\xbf',
    'cut_off_tag': b'<head><title>t</title><div class="x',
    'only_comment': b'<!-- only -->',
    'whitespace_only': b' \n\t',
    'empty': b'',
}


@pytest.mark.parametrize('name', sorted(XML_CASES))
def test_xml_tree_matches_lxml(name):
    _same(XML_CASES[name], html=False)


@pytest.mark.parametrize('name', sorted(HTML_CASES))
def test_html_tree_matches_lxml(name):
    _same(HTML_CASES[name], html=True)


def test_the_cases_raise_where_lxml_raises():
    """The raising XML cases above do raise (the dumps compare equal
    either way; this keeps the cases honest)."""
    raised = {name for name, data in XML_CASES.items()
              if _parse(lxml_etree, data, False) == 'XMLSyntaxError'}
    assert {'undefined_entity', 'xhtml_nbsp', 'duplicate_attribute',
            'unbound_prefix', 'junk_after_root', 'empty'} <= raised
    assert 'relative_default_namespace' not in raised
    assert _parse(lxml_etree, HTML_CASES['only_comment'], True) is None


def test_itertext_skips_comment_text_and_keeps_tails():
    data = b'<r><p>a<!-- c -->d<b>x</b>y<?pi q?>z</p></r>'
    for mod in (etree_compat, lxml_etree):
        assert list(mod.fromstring(data).itertext()) == \
            ['a', 'd', 'x', 'y', 'z']


def test_find_iter_and_qname_match_lxml():
    data = (b'<package xmlns="u:opf"><metadata xmlns:dc="u:dc"><dc:title>'
            b'T</dc:title><meta property="p">v</meta></metadata><manifest>'
            b'<item id="a"/><item id="b"/></manifest><nav/><x:nav '
            b'xmlns:x="u:x"/><!-- c --></package>')
    paths = ('.//{*}metadata/{*}meta', './/{*}manifest/{*}item',
             './/{*}title', '{*}metadata', './/{*}missing')

    def view(mod):
        root = mod.fromstring(data)
        return ([[e.get('id') or e.text for e in root.findall(p)]
                 for p in paths],
                [getattr(root.find(p), 'tag', None) for p in paths],
                [e.tag for e in root.iter('{*}nav')],
                [mod.QName(e).localname for e in root.iter()
                 if isinstance(e.tag, str)])
    assert view(etree_compat) == view(lxml_etree)


@pytest.mark.parametrize('tag', ['{u}a', 'a', 'x-y', 'a.b', '\xe9', '_a',
                                 'a:b', '', '1a', '-a', '{u}', '{u}a:b',
                                 'p<b', None])
def test_qname_localname_or_error_matches_lxml(tag):
    def outcome(mod):
        try:
            return mod.QName(tag).localname
        except ValueError:
            return 'ValueError'
    assert outcome(etree_compat) == outcome(lxml_etree)


def test_qname_of_a_comment_raises_as_lxml():
    for mod in (etree_compat, lxml_etree):
        comment = next(iter(mod.fromstring(b'<r><!-- c --></r>')))
        with pytest.raises(ValueError):
            mod.QName(comment)


# --- generated documents ------------------------------------------------

_TAGS = ('a abbr address b big blockquote body br caption center code col '
         'colgroup dd div dl dt em font form h1 h2 head hr html i img input '
         'li link map menu meta noscript ol option p pre s script select '
         'small span strike strong style sub sup table tbody td textarea '
         'tfoot th thead title tr tt u ul xmp iframe plaintext frameset '
         'frame noframes section nav svg rect foo').split()
_TEXT = [b'x', b' ', b'\n', b'a b', b'&amp;', b'&nbsp;', b'&copy', b'&#65;',
         b'&#x80;', b'&notit;', b'&', b'<', b'>', b'</', b'<!-- c -->',
         b'<!-->', b'<?pi x?>', b'<![CDATA[q>r]]>', b'<!DOCTYPE html>',
         b'\r\n', b'"', b'=', b'/', b'\x00', b'\xe9', b'\xc3\xa9', b'</ x>',
         b'< p>', b'<!--', b'-->', b'<script>', b'</script>', b'\t']
_ATTRS = [b' class=x', b' id="y"', b" style='a:b'", b' disabled', b' a=1 a=2',
          b' href="u&amp;v&copy=z"', b' x', b' A=B', b' y="a>b"', b' /z',
          b' xml:lang=en', b' epub:type="toc"']


def _tag_soup(rng):
    parts = []
    for _ in range(rng.randint(1, 30)):
        r = rng.random()
        tag = rng.choice(_TAGS).encode()
        if rng.random() < 0.2:
            tag = tag.upper()
        if r < 0.35:
            attrs = b''.join(rng.choice(_ATTRS)
                             for _ in range(rng.choice((0, 0, 1, 2))))
            parts.append(b'<%s%s%s>' % (tag, attrs,
                                        b'/' if rng.random() < 0.05 else b''))
        elif r < 0.6:
            parts.append(b'</%s>' % tag)
        else:
            parts.append(rng.choice(_TEXT))
    return b''.join(parts)


def _xml_doc(rng):
    names = ['r', 'p', 'e:a', 'b', 'x:y']
    text = ['a', ' ', '\n', '&amp;', '&#x263a;', '<!-- c -->', '<?pi d?>',
            '<![CDATA[<q>]]>', '&nbsp;', '\r\n', '\xe9', '&e;']

    def elem(depth):
        name = rng.choice(names)
        attrs = ''.join(rng.choice([' k="v"', " xml:lang='en'", ' e:z="1"',
                                    ' xmlns="u"', ' xmlns:e="w"', ''])
                        for _ in range(rng.randint(0, 2)))
        if depth > 3 or rng.random() < 0.3:
            return '<%s%s/>' % (name, attrs)
        inner = ''.join(rng.choice(text) if rng.random() < 0.5
                        else elem(depth + 1)
                        for _ in range(rng.randint(0, 4)))
        return '<%s%s>%s</%s>' % (name, attrs, inner, name)
    doc = bytearray((rng.choice(['', '<?xml version="1.0"?>',
                                 '<!DOCTYPE r [<!ENTITY e "E">]>',
                                 '<!-- pre -->'])
                     + '<r xmlns:e="v" xmlns:x="y">' + elem(0) + '</r>'
                     + rng.choice(['', '\n', '<!-- post -->'])
                     ).encode('utf-8'))
    for _ in range(rng.choice((0, 0, 1, 2))):
        j = rng.randrange(len(doc))
        op = rng.random()
        if op < 0.4:
            del doc[j]
        elif op < 0.8:
            doc[j:j] = rng.choice([b'<', b'&', b'>', b'"', b'/', b'a', b' '])
        else:
            doc[j] = rng.randrange(256)
    return bytes(doc)


@pytest.mark.parametrize('seed', range(4))
def test_generated_tag_soup_matches_lxml(seed):
    rng = random.Random(seed)
    for _ in range(150):
        _same(_tag_soup(rng), html=True)


@pytest.mark.parametrize('seed', range(4))
def test_generated_xml_matches_lxml(seed):
    rng = random.Random(100 + seed)
    for _ in range(150):
        _same(_xml_doc(rng), html=False)


# --- libxml2's tables, read off lxml --------------------------------------

_RAW = {'iframe', 'noframes', 'plaintext', 'script', 'style', 'textarea',
        'title', 'xmp'}


def _lxml_html(data):
    return lxml_etree.fromstring(data.encode(),
                                 lxml_etree.HTMLParser(encoding='utf-8'))


def test_start_tag_auto_close_table_is_libxml2s():
    """For every open element and start tag: lxml closes the element
    exactly where ``_CLOSED_BY`` says."""
    olds = [t for t in _TAGS if t not in _RAW and t not in
            etree_compat._VOID and t not in ('html', 'body', 'head')]
    found = {}
    for old in olds + ['head']:
        for new in _TAGS:
            if old == 'head':
                root = _lxml_html('<html><head><%s>y' % new)
                el = root.find('head')
                if new in ('html', 'head'):
                    closed = False    # both dropped, nothing to see
                else:
                    news = [e for e in root.iter(new)]
                    closed = not news or news[0].getparent() is not el
            else:
                root = _lxml_html('<body><%s>x<%s>y' % (old, new))
                el = next(root.iter(old))
                if new in ('html', 'head', 'body'):
                    closed = el.text != 'xy'
                else:
                    news = [e for e in root.iter(new) if e is not el]
                    closed = news[0].getparent() is not el
            if closed:
                found.setdefault(old, set()).add(new)
    table = {k: set(v) & set(_TAGS) for k, v in
             etree_compat._CLOSED_BY.items() if k in olds + ['head']}
    assert found == {k: v for k, v in table.items() if v}


def test_end_tag_priorities_are_libxml2s():
    """``</outer>`` with ``inner`` open closes both exactly when inner's
    priority is not above outer's."""
    tags = [t for t in _TAGS if t not in _RAW and t not in
            etree_compat._VOID and t not in ('html', 'head', 'body')]
    prio = etree_compat._END_PRIORITY
    for outer in tags:
        for inner in tags:
            if inner == outer or outer in etree_compat._CLOSED_BY.get(
                    inner, ()) or inner in etree_compat._CLOSED_BY.get(
                    outer, ()):
                continue
            root = _lxml_html('<body><%s>a<%s>b</%s>y' % (outer, inner,
                                                           outer))
            el = [e for e in root.iter(inner)][-1]
            closed = el.text == 'b'
            assert closed == (prio.get(inner, 100) <= prio.get(outer, 100)), \
                (outer, inner)
