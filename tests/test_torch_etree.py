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

import io
import os
import random
import sys

import pytest

lxml_etree = pytest.importorskip('lxml.etree')

from archive_pdf_tools_tpu_torch.utils import etree_compat  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import hocr_cases  # noqa: E402


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
    doc = bytearray(_xml_clean(rng))
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


def _xml_clean(rng):
    """A well-formed document: namespaces, an internal DTD's entity,
    CDATA, comments, PIs, references."""
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
    return (rng.choice(['', '<?xml version="1.0"?>',
                        '<!DOCTYPE r [<!ENTITY e "E">]>', '<!-- pre -->'])
            + '<r xmlns:e="v" xmlns:x="y">' + elem(0) + '</r>'
            + rng.choice(['', '\n', '<!-- post -->'])).encode('utf-8')


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


# --- iterparse: libxml2's recovery, as inputs/hocr.py reads hOCR -----------

# small documents, each on one rule of _Recover (read off lxml): stray
# '<' and '&', references, attributes, end tags, bytes that are not
# UTF-8, comments, PIs and CDATA, the epilog, the end of the input, the
# entities that an error stops, and the last bytes of a cut file
RECOVERY_CASES = [
    b'<r><a>Hi&nbsp;there <b>x</b></a></r>',
    b'<r><a>A&B next<b>n</b></a></r>',
    b'<r><a><head><meta charset="utf-8"></head><b>x</b></a></r>',
    b'<r><a>x < y</a><b/></r>',
    b'<r><a>x<1</a><b/></r>',
    b'<r><a>x<>y</a><b/></r>',
    b'<r><a>x<</a></r>',
    b'<r><a>x<',
    b'<r>&</r>',
    b'<r>a& b</r>',
    b'<r>a&;b</r>',
    b'<r>a&#;b</r>',
    b'<r>a&#x;b</r>',
    b'<r>a&#65 b</r>',
    b'<r>a&#0;b</r>',
    b'<r>a&lt b</r>',
    b'<r>a&ab',
    b'<r>a&#1114112;b</r>',
    b'<r>a&lt;&gt;&amp;&quot;&apos;b</r>',
    b'<r><a>x &amp; <c>y</c>&</a><b/>zz</r>',
    b'<r><q><a>x < y</a><b/></q></r>',
    b'<r>a &#x41;&#65;</r>',
    b'<r>a&#x4g1;b<c/></r>',
    b'<r><a b>x</a><c/></r>',
    b'<r><a b=>x</a><c/></r>',
    b'<r><a b="x>y</a><c/>z"></r>',
    b'<r><a b="x<y">q</a><c/></r>',
    b'<r><a b=x>q</a><c/></r>',
    b'<r><a "b">q</a><c/></r>',
    b'<r><a b="1"c="2">q</a><c/></r>',
    b'<r><a/ >q</a><c/></r>',
    b'<r><a b="1" b="2">q</a><c/></r>',
    b'<r><a b="1" >q</a  x><c/></r>',
    b'<r><a>q</ a><c/></r>',
    b'<r><a>q</><c/></r>',
    b'<r><a>q</a',
    b'<r><a',
    b'<r><a b="',
    b'<r><a b="1"',
    b'<r><a>q</b><c/></r>',
    b'<r><a>q</aa><c/></r>',
    b'<r><aa>q</a><c/></r>',
    b'<r><a>o\xffk caf\xc3\xa9 \xc3(x \xe2\x82y</a><c/></r>',
    b'<r><a\xff>q</a><c/></r>',
    b'<r><a b\xff="1">q</a><c/></r>',
    b'<r><a b="1\xff2">q</a><c/></r>',
    b'<r><a>q</a\xff><c/></r>',
    b'<r><a>q&a\xffb;</a><c/></r>',
    b'<r><\xffa>q</a><c/></r>',
    b'<r><a b="x&amp;y&z; &q &#65;&#;w">q</a><c/></r>',
    b'<r><a b="x&y">q</a><c/></r>',
    b'<r><a b="x& y">q</a><c/></r>',
    b'<r><a b c="1">q</a><c/></r>',
    b'<r><a b="1\n2\t3">q</a><c/></r>',
    b'<r><a b="x&">q</a><c/></r>',
    b'<r><a b="x&y;">q</a><c/></r>',
    b'<r><a b="1" \xff>q</a><c/></r>',
    b'<r><a>x<!-- c -->y<?pi data?>z<![CDATA[<&>]]>w</a><c/></r>',
    b'<r><a>x<!-- c -- d -->y</a><c/></r>',
    b'<r><a>x<!-- c </a><c/></r>',
    b'<r><a>x<?pi </a><c/></r>',
    b'<r><a>x<![CDATA[ c </a><c/></r>',
    b'<r><a>x<!x>y</a><c/></r>',
    b'<r><a>q</a></r>\n<!-- c -->\n<x/>',
    b'<r><a>q</a></r></r>',
    b'<r><a>q</a></r>text',
    b'<r><a>q</a></r><?p x?>  ',
    b'<r><a>x<?xml version="1.0"?>y</a></r>',
    b'<r><a>x\x01y</a><c/></r>',
    b'<r><a b="x\x01y">q</a><c/></r>',
    b'<r><a\x01>q</a><c/></r>',
    b'',
    b'  \n',
    b'<?xml version="1.0"?>\n',
    b'junk',
    b'<r><a>q</',
    b'<r><a>q<?',
    b'<r><a>x<? y?>z</a><c/></r>',
    b'<r><a>x<?1y?>z</a><c/></r>',
    b'<r><a>x<?py?>z<?p\ty?></a><c/></r>',
    b'<r><a>x<!-->z--></a><c/></r>',
    b'<r><a>x<!--->z--></a><c/></r>',
    b'<r><a>x<!--a\xffb-->z</a><c/></r>',
    b'<r><a>a\r\nb\rc</a><c b="1\r\n2"/></r>',
    b'<?xml version="1.0"?><!-- x --><r><a>q</a></r>',
    b'<r><a>&#65</a></r>',
    b'<r>\xff&amp;</r>',
    b'<r><a b="1" b="2"/>&amp;</r>',
    b'<r><a b=x/>&amp;</r>',
    b'<r><!-- a -- b -->&amp;</r>',
    b'<r xmlns:a="u"><b:c/>&amp;</r>',
    b'<r>\x01&amp;</r>',
    b'<r><?xml x?>&amp;</r>',
    b'<!DOCTYPE r [<!ENTITY e "E&#65;">]><r>&e;<x/>&nbsp;&e;&amp;'
    b'<y a="&e;"/></r>',
    b'<r><a>&#0;&amp;</a></r>',
    b'<r xmlns="">&amp;</r>',
    b'<!DOCTYPE r PUBLIC "-//W3C//DTD XHTML 1.0 Transitional//EN" "x.dtd">'
    b'<r>x&nbsp;y&amp;z<a b="&amp;&nbsp;q">&lt;</a></r>',
    b'<r>x&nbsp;y&amp;z<a b="&amp;&lt;q">&lt;&#65;</a></r>',
    b'<r>x&lt;<a b="&amp;"/>&gt;<b>&amp;&#65;</b>&nbsp;<c b="&amp;&lt;"/>'
    b'&amp;</r>',
    b'<r>caf\xc3',
    b'<r>a\xe2\x82',
    b'<r>a\xff',
    b'<r>a\xf0\x9f\x98',
    b'<r>a\xc3<b/>',
    b'<r b="a\xc3',
    b'<r>a\xe2\x82b</r>',
    b'<r>a\xed\xa0\x80b</r>',
    b'<r>a\xf4\x90\x80\x80b</r>',
    b'<r>a\xc0\xafb</r>',
    b'<r>ok</r>\xff',
    b'<r>ab]]>cd</r>', b'<r>a]]>b]]>c</r>', b'<r>ab<x/>cd]]>ef&amp;g</r>',
    b'<r>\xc3\xa9a]]>b</r>', b'<r>a\r\nb]]>c</r>', b'<r>a\rb]]>c</r>',
    b'<r>a\x01b]]>c</r>', b'<r>\xc3\xa9\x01b]]>c</r>',
    # before the root element: the XML declaration, a DOCTYPE (a second
    # one stops the parser), comments, PIs, a byte order mark
    b'<?xml version="1.0"?>\n<!-- c -->\n<r a="1"b="2">x</r>',
    b'<!DOCTYPE r SYSTEM "r.dtd">\n<r a="1"b="2">x&nbsp;<s/></r>',
    b'<?xml version="1.0"?>\n<r&>x</r>', b'\n\n<r b="1\xff">x</r>',
    b'junk<r>x</r>', b'<?pi x?><r a=1>x</r>', b'<!-- a -- b --><r>x</r>',
    b'<!DOCTYPE r [<!ENTITY e "E">]><r a="&e;"b="2">&e;x</r>',
    b'<!DOCTYPE r SYSTEM "r.dtd"><!DOCTYPE r><r>x</r>', b'<r/><r/>',
    b'\xef\xbb\xbf<r a="1"b>x</r>',
    b'<?xml version="1.0"?><!DOCTYPE r SYSTEM "r.dtd"><r a="1"b>&amp;'
    b'&nbsp;&amp;x</r>',
]


# where expat's half hands over to the recovering one
_LONG = 'x' * 50000
BOUNDARY_CASES = {
    'in_a_tag': b'<r><a b="1" c="2"d="3">x</a><b>y&amp;</b></r>',
    'in_a_long_text_run': ('<r><a>%s&nbsp;%s&amp;</a><b/></r>'
                           % (_LONG, _LONG)).encode(),
    'in_a_tag_after_a_long_text_run': ('<r><a>%s<b c="1"d="2">y</b>'
                                       '&amp;</a></r>' % _LONG).encode(),
    'cr_lf_across_a_read': ('<r><a>%s\r\n&nbsp;y</a></r>'
                            % ('x' * (32768 - 7))).encode(),
    'at_a_read_boundary': ('<r><a>%s&nbsp;y<b/></a></r>'
                           % ('x' * (32768 - 6))).encode(),
    'after_namespace_declarations': b'<r xmlns="u:d" xmlns:p="u:p"><p:a '
                                    b'p:k="v">x&nbsp;<b/></p:a><c xmlns="u:c'
                                    b'">y<d p:q="1"/>&z;</c><p:e/></r>',
    'after_a_default_namespace_on_an_inner_element':
        b'<r><a xmlns="u:a"><b>x</b>&q;<c/></a><d/></r>',
    'in_an_attribute_value': b'<r><a title="bbox 1 2&3">x</a><b t="a<b"/>'
                             b'<c t="x&nbsp;y"/>&amp;</r>',
    'after_an_empty_element_tag': b'<r><a/>&x;<c/></r>',
    'after_an_empty_element': b'<r><b></b>&x;<c/></r>',
    'inside_cdata': b'<r><![CDATA[a\xffb]]>c&x;</r>',
    'after_a_comment_and_a_pi': b'<r><!-- c --><?p d?>&x;<e/></r>',
    'after_a_comment_that_opens_with_its_close': b'<r><a><!--> c -->x</b>'
                                                 b'</r>',
    'in_the_epilog': b'<r><a/></r><!-- c --><b/>',
    'in_the_root_start_tag': b'<?xml version="1.0"?>\n<!-- c -->\n<r a="1"'
                             b'b="2">&amp;<a>x</a></r>',
    'external_dtd_and_standalone': b'<?xml version="1.0" standalone="yes"?>'
                                   b'<!DOCTYPE r SYSTEM "r.dtd"><r>a&nbsp;b'
                                   b'&amp;</r>',
}


def _iter_view(mod, data, consume=False):
    """What ``mod.iterparse(data)`` shows: for each ('end', element)
    event, the element as it is then (tag, attributes, text,
    ``itertext()``), and the dump of the tree at the end; with
    ``consume``, each ocr_page element is cleared and its earlier
    siblings deleted as it comes, as inputs/hocr.py does.  Attributes
    compare as a dict: lxml keeps a repeated attribute's second node,
    whose value ``get()`` never gives."""
    ctx = mod.iterparse(io.BytesIO(data), events=('end',), html=False,
                        recover=True, huge_tree=True)
    events = []
    try:
        for _, el in ctx:
            events.append((el.tag, sorted(dict(el.attrib).items()), el.text,
                           list(el.itertext())))
            if consume and isinstance(el.tag, str) and \
                    el.tag.endswith('div') and \
                    (el.get('class') or '').strip() == 'ocr_page':
                el.clear()
                parent = el.getparent()
                if parent is not None:
                    while el.getprevious() is not None:
                        del parent[0]
    except mod.XMLSyntaxError:
        events.append('XMLSyntaxError')
    dump = _dump(ctx.root, mod)
    if dump is not None:
        dump = [d[:3] + (None if d[3] is None else sorted(dict(d[3]).items()),)
                + d[4:] for d in dump]
    return events, dump


def _iter_same(data):
    for consume in (False, True):
        assert _iter_view(etree_compat, data, consume) == \
            _iter_view(lxml_etree, data, consume), (consume, data[:300])


@pytest.mark.parametrize('data', RECOVERY_CASES)
def test_iterparse_recovers_as_lxml(data):
    _iter_same(data)


@pytest.mark.parametrize('name', sorted(hocr_cases.CASES))
def test_iterparse_reads_the_c16_rows_as_lxml(name):
    _iter_same(hocr_cases.CASES[name])


@pytest.mark.parametrize('name', sorted(BOUNDARY_CASES))
def test_iterparse_hands_over_from_expat_as_lxml(name):
    _iter_same(BOUNDARY_CASES[name])


@pytest.mark.parametrize('group', range(10))
def test_iterparse_reads_mutated_hocr_as_lxml(group):
    for seed in range(group * 20, group * 20 + 20):
        _iter_same(hocr_cases.mutated(seed))


def _long_mutated(seed):
    """60 generated pages (past two of lxml's 32 KiB reads) with 1-4
    insertions or deletions, half of them at a read's boundary, cut
    short one time in five."""
    rng = random.Random(seed)
    words = hocr_cases.VOCABULARY
    pages = [hocr_cases._line([rng.choice(words) for _ in range(8)])
             for _ in range(60)]
    data = bytearray(hocr_cases._document(pages))
    lo = data.index(b'<html')
    for _ in range(rng.randint(1, 4)):
        if rng.random() < 0.5:
            k = 32768 * rng.randint(1, 2) + rng.randint(-40, 40)
        else:
            k = rng.randrange(lo, len(data))
        if rng.random() < 0.6:
            data[k:k] = rng.choice(hocr_cases.INSERTS)
        elif data[k] in b'<&>"':
            del data[k]
    if rng.random() < 0.2:
        del data[rng.randrange(lo, len(data)):]
    return bytes(data)


@pytest.mark.parametrize('seed', range(6))
def test_iterparse_reads_long_mutated_hocr_as_lxml(seed):
    _iter_same(_long_mutated(seed))


def _body_mutated(rng):
    """A document of _xml_clean's with 1-3 insertions, deletions or
    changed bytes after the root's start tag (_Recover does not follow
    libxml2 through a broken XML declaration or DOCTYPE)."""
    doc = bytearray(_xml_clean(rng))
    lo = doc.index(b'<r xmlns:e="v" xmlns:x="y">') + 27
    for _ in range(rng.randint(1, 3)):
        k = rng.randrange(lo, len(doc))
        op = rng.random()
        if op < 0.4:
            del doc[k]
        elif op < 0.8:
            doc[k:k] = rng.choice([b'<', b'&', b'>', b'"', b'/', b'a', b' ',
                                   b'\xff'])
        else:
            doc[k] = rng.randrange(256)
    return bytes(doc)


@pytest.mark.parametrize('seed', range(4))
def test_iterparse_reads_generated_xml_as_lxml(seed):
    """Namespaces, entities of an internal DTD, CDATA, comments and PIs
    around the errors."""
    rng = random.Random(200 + seed)
    for _ in range(100):
        _iter_same(_body_mutated(rng))


def test_iterparse_live_tree_matches_lxml():
    """clear() drops text, tail, attributes and children; getprevious()
    sees comments and PIs; del parent[0] takes the tail along;
    getparent() after a sibling's deletion; the root after the end."""
    data = (b'<r><a k="v">t<b/>u</a>ta<!-- c -->tc<p>x</p>tp<?q z?>tq'
            b'<s><i>1</i><j>2</j></s>ts</r>')

    def view(mod):
        out = []
        ctx = mod.iterparse(io.BytesIO(data), events=('end',), html=False,
                            recover=True, huge_tree=True)
        for _, el in ctx:
            prev = el.getprevious()
            out.append((el.tag, None if prev is None else (
                prev.tag if isinstance(prev.tag, str) else prev.text)))
            if el.tag == 'a':
                el.clear()
                out.append((el.text, el.tail, dict(el.attrib), len(el)))
            if el.tag == 'p':
                parent = el.getparent()
                while el.getprevious() is not None:
                    del parent[0]
                out.append((parent.text, len(parent), el.getparent().tag,
                            el.getprevious()))
            if el.tag == 'j':
                out.append(el.getparent().tag)
        out.append(_dump(ctx.root, mod))
        return out
    assert view(etree_compat) == view(lxml_etree)


def test_iterparse_takes_only_the_hocr_arguments():
    src = io.BytesIO(b'<r/>')
    assert [e for e, _ in etree_compat.iterparse(
        src, events=('end',), html=False, recover=True,
        huge_tree=True)] == ['end']
    for kw in ({'events': ('start', 'end')}, {'html': True},
               {'recover': False}, {'huge_tree': False}):
        args = dict(events=('end',), html=False, recover=True,
                    huge_tree=True)
        args.update(kw)
        with pytest.raises(TypeError):
            etree_compat.iterparse(io.BytesIO(b'<r/>'), **args)


@pytest.mark.parametrize('name', sorted(XML_CASES))
def test_parse_raises_where_lxml_parse_raises(tmp_path, name):
    """parse() of a path and of a file: lxml.etree.parse's tree, or its
    XMLSyntaxError."""
    path = tmp_path / 'doc.xml'
    path.write_bytes(XML_CASES[name])

    def outcome(mod, source):
        try:
            return _dump(mod.parse(source).getroot(), mod)
        except mod.XMLSyntaxError:
            return 'XMLSyntaxError'
    for source in (str(path), lambda: open(path, 'rb')):
        a = outcome(etree_compat, source() if callable(source) else source)
        b = outcome(lxml_etree, source() if callable(source) else source)
        assert a == b
