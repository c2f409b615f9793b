"""epub-to-pdf on the port held against the JAX package's converter.

The port's ``cli/epub_to_pdf.py`` is a copy of the JAX converter whose
``etree`` is ``utils/etree_compat.py`` (the standard library, no lxml).
Each input must give the same PDF bytes through both:

- every test of ``tests/test_epub_*.py`` and ``tests/test_xps.py`` that
  runs the converter runs again here with its ``main`` swapped for one
  that runs both converters on the same input and asserts equal bytes
  (the test's own assertions still hold the JAX output);
- ``CASES`` are this module's own inputs: a reflowable book with styles,
  lists, tables, images, a nav TOC and links; comments, processing
  instructions and entities inside styled runs and list items; chapters
  that are not well-formed XML (the HTML fallback, reflowed and fixed
  layout); a fixed-layout book; an XPS with an obfuscated font.
  ``JAX_SHA256`` pins the JAX converter's output for each, with
  matplotlib's AFM metrics and fontTools (``'full'``) and without them
  (``'bare'``, the converter's monospace and standard-14 fallbacks).

``chip_smoke.py`` phase 3f loads this module by path on a machine that
has no lxml (and may lack matplotlib and fontTools), runs
``bin/epub-to-pdf_torch`` on each case and holds the output to its pin,
so nothing of the JAX package is imported here at module level.
"""

import ast
import base64
import hashlib
import importlib.util
import inspect
import io
import os
import subprocess
import sys
import zipfile

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(ROOT, 'tests')
GLYPHLESS = os.path.join(ROOT, 'archive_pdf_tools_tpu_torch', 'data',
                         'glyphless.ttf')

OPF_NS = 'http://www.idpf.org/2007/opf'
XPS_NS = 'http://schemas.microsoft.com/xps/2005/06'
CONTAINER = ('<?xml version="1.0"?>\n<container version="1.0" '
             'xmlns="urn:oasis:names:tc:opendocument:xmlns:container">'
             '<rootfiles><rootfile full-path="OEBPS/content.opf" '
             'media-type="application/oebps-package+xml"/></rootfiles>'
             '</container>')

# a 32 x 24 baseline JPEG, kept as bytes so that every machine embeds
# the same stream (the converter passes JPEG data through)
JPEG = base64.b64decode('''
/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAA0JCgsKCA0LCgsODg0PEyAVExISEyccHhcgLikx
MC4pLSwzOko+MzZGNywtQFdBRkxOUlNSMj5aYVpQYEpRUk//2wBDAQ4ODhMREyYVFSZPNS01
T09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT09PT0//wAAR
CAAYACADASIAAhEBAxEB/8QAHwAAAQUBAQEBAQEAAAAAAAAAAAECAwQFBgcICQoL/8QAtRAA
AgEDAwIEAwUFBAQAAAF9AQIDAAQRBRIhMUEGE1FhByJxFDKBkaEII0KxwRVS0fAkM2JyggkK
FhcYGRolJicoKSo0NTY3ODk6Q0RFRkdISUpTVFVWV1hZWmNkZWZnaGlqc3R1dnd4eXqDhIWG
h4iJipKTlJWWl5iZmqKjpKWmp6ipqrKztLW2t7i5usLDxMXGx8jJytLT1NXW19jZ2uHi4+Tl
5ufo6erx8vP09fb3+Pn6/8QAHwEAAwEBAQEBAQEBAQAAAAAAAAECAwQFBgcICQoL/8QAtREA
AgECBAQDBAcFBAQAAQJ3AAECAxEEBSExBhJBUQdhcRMiMoEIFEKRobHBCSMzUvAVYnLRChYk
NOEl8RcYGRomJygpKjU2Nzg5OkNERUZHSElKU1RVVldYWVpjZGVmZ2hpanN0dXZ3eHl6goOE
hYaHiImKkpOUlZaXmJmaoqOkpaanqKmqsrO0tba3uLm6wsPExcbHyMnK0tPU1dbX2Nna4uPk
5ebn6Onq8vP09fb3+Pn6/9oADAMBAAIRAxEAPwDhIbP2q9DZ+1aMNn7Vehs/aojMzwuMM6Gz
9qvQ2ftWjDZ+1XobP2raMz6LC4wqQ2ftV6Gz9qKK8+LZ+d4WrIvQ2ftV6Gz9qKK2i2fQ4WrI
/9k=''')


def _png(w=20, h=12):
    """A gray gradient PNG (the converter decodes it and deflates the
    pixels, so the encoder's bytes do not reach the PDF)."""
    import numpy as np
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(((np.arange(w)[None, :] * 12 + np.arange(h)[:, None] * 7)
                     % 256).astype(np.uint8)).save(buf, format='PNG')
    return buf.getvalue()


def _zip(path, members):
    with zipfile.ZipFile(path, 'w') as zf:
        for name, data in members:
            info = zipfile.ZipInfo(name, date_time=(2020, 1, 1, 0, 0, 0))
            zf.writestr(info, data)


def _opf(title, items, spine, meta=''):
    """content.opf: items [(id, href, media-type, properties)], spine
    [(idref, properties)]."""
    man = ''.join('<item id="%s" href="%s" media-type="%s"%s/>'
                  % (i, h, m, ' properties="%s"' % p if p else '')
                  for i, h, m, p in items)
    refs = ''.join('<itemref idref="%s"%s/>'
                   % (i, ' properties="%s"' % p if p else '')
                   for i, p in spine)
    return ('<?xml version="1.0" encoding="utf-8"?>\n'
            '<package xmlns="%s" version="3.0" unique-identifier="uid">'
            '<metadata xmlns:dc="http://purl.org/dc/elements/1.1/">'
            '<dc:identifier id="uid">urn:uuid:0f1e2d3c-4b5a-6978-8796-a5b4c3d2e1f0'
            '</dc:identifier><dc:title>%s</dc:title>'
            '<dc:creator>A. Writer</dc:creator><dc:language>en</dc:language>'
            '%s</metadata><manifest>%s</manifest><spine>%s</spine>'
            '</package>' % (OPF_NS, title, meta, man, refs))


def _xhtml(body, head='', decl=True, doctype=''):
    return (('<?xml version="1.0" encoding="utf-8"?>\n' if decl else '')
            + doctype
            + '<html xmlns="http://www.w3.org/1999/xhtml" '
            'xmlns:epub="http://www.idpf.org/2007/ops"><head>'
            '<title>t</title>%s</head><body>%s</body></html>' % (head, body))


def build_reflow(path):
    """A reflowable book: linked and inline CSS, headings, styled and
    linked runs, nested lists, a table, floated and block images, pre,
    blockquote, hr, an inline SVG, a page break and an EPUB 3 nav."""
    nav = _xhtml(
        '<nav epub:type="toc"><h1>Contents</h1><ol>'
        '<li><a href="ch1.xhtml">Chapter <em>One</em></a><ol>'
        '<li><a href="ch1.xhtml#lists">Lists</a></li></ol></li>'
        '<li><a href="ch2.xhtml">Chapter Two</a></li></ol></nav>')
    ch1 = _xhtml(
        '<h1 id="top">Chapter One</h1>'
        '<p class="lead">A <b>bold</b>, <i>italic</i> and <b><i>both</i></b>'
        ' run with <a href="https://example.org/x">an outside link</a>, '
        '<a href="ch2.xhtml#end">a link on</a>, x<sup>2</sup> and '
        'H<sub>2</sub>O.</p>'
        '<p style="text-align:center; color:#336699">Centred and blue.</p>'
        '<p class="indent">' + 'Long text wraps over the column. ' * 12 +
        '</p>'
        '<div><img src="img/pic.jpg" style="float:right; width:64px"/></div>'
        '<p>' + 'Text beside the floated picture. ' * 8 + '</p>'
        '<h2 id="lists">Lists</h2><ul><li>one</li><li>two<ol>'
        '<li>two a</li><li>two b</li></ol></li><li>three</li></ul>'
        '<table border="1"><caption>Table</caption>'
        '<tr><th>Head</th><th colspan="2">Wide head</th></tr>'
        '<tr><td>a</td><td width="30%">b</td><td>c</td></tr>'
        '<tr><td rowspan="2">d</td><td>e</td><td>f</td></tr>'
        '<tr><td>g</td><td><a href="#top">h</a></td></tr></table>'
        '<blockquote>Quoted words.</blockquote>'
        '<pre>  pre  line one\n    line two</pre><hr/>'
        '<div>Bare text in a div<br/>after a break.</div>',
        head='<link rel="stylesheet" type="text/css" href="style.css"/>'
             '<style>.lead { font-size: 1.2em } p.x { }</style>')
    ch2 = _xhtml(
        '<section style="page-break-before: always"><h2>Chapter Two</h2>'
        '<dl><dt>term</dt><dd>its definition</dd></dl>'
        '<p><img src="img/gray.png" alt="gray"/></p>'
        '<svg xmlns="http://www.w3.org/2000/svg" width="120" height="60" '
        'viewBox="0 0 120 60"><rect x="5" y="5" width="50" height="40" '
        'fill="#cc0000"/><circle cx="90" cy="30" r="20" stroke="blue" '
        'fill="none"/><polygon points="60,55 70,40 80,55"/></svg>'
        '<p id="end" style="text-transform:uppercase; line-height:2">'
        'The end.</p></section>')
    css = ('body { font-family: serif } .indent { text-indent: 2em; '
           'margin-left: 20px } h2 { text-align: right }')
    items = [('nav', 'nav.xhtml', 'application/xhtml+xml', 'nav'),
             ('c1', 'ch1.xhtml', 'application/xhtml+xml', ''),
             ('c2', 'ch2.xhtml', 'application/xhtml+xml', ''),
             ('css', 'style.css', 'text/css', ''),
             ('i1', 'img/pic.jpg', 'image/jpeg', ''),
             ('i2', 'img/gray.png', 'image/png', '')]
    _zip(path, [('mimetype', 'application/epub+zip'),
                ('META-INF/container.xml', CONTAINER),
                ('OEBPS/content.opf',
                 _opf('Reflow Book', items, [('c1', ''), ('c2', '')])),
                ('OEBPS/nav.xhtml', nav), ('OEBPS/ch1.xhtml', ch1),
                ('OEBPS/ch2.xhtml', ch2), ('OEBPS/style.css', css),
                ('OEBPS/img/pic.jpg', JPEG), ('OEBPS/img/gray.png', _png())])


def build_markup(path):
    """Comments, processing instructions, CDATA and entities (predefined,
    numeric and declared in the DOCTYPE) inside styled runs, list items,
    a style block, headings and an EPUB 2 NCX."""
    doctype = ('<!DOCTYPE html [<!ENTITY pub "Publisher &amp; Sons">'
               '<!ENTITY mark "&#8482;">]>\n')
    ch = _xhtml(
        '<!-- before the heading --><h1>Mark<!-- x -->up &amp; '
        '<?pi inside?>entities</h1>'
        '<p class="c">a<!-- c -->b <b>bo<?pi x?>ld &amp; <!--x-->more</b> '
        '&#x263A; &lt;tag&gt; &pub;&mark; <i xml:lang="fr">'
        'it<!--c-->alic</i><![CDATA[ <raw> & ]]>tail</p>'
        '<ul><li>one<!-- c --> two<?pi?></li><li><i>it<!--c-->em</i> '
        '&#169; <b>b<!--c--></b>x</li><!-- between --><li>three'
        '<ol><!-- c --><li>nested<?pi?></li></ol></li></ul>'
        '<ol><li>first</li><!-- c --><?pi?><li>second</li></ol>'
        '<div>Direct<!-- c --> text <p>inner</p> and a tail</div>'
        '<pre>pre<!-- c -->\n  kept &amp; <b>bold</b></pre>',
        head='<style>/* css */ .c { color: red }<!-- hidden { } -->'
             '</style>', doctype=doctype)
    ncx = ('<?xml version="1.0"?><ncx xmlns="http://www.daisy.org/z3986/'
           '2005/ncx/" version="2005-1"><navMap><navPoint id="n1">'
           '<navLabel><text>Mark<!-- c -->up</text></navLabel>'
           '<content src="ch.xhtml"/><navPoint id="n2"><navLabel><text>'
           'Lists &amp; more</text></navLabel><content src="ch.xhtml#l"/>'
           '</navPoint></navPoint></navMap></ncx>')
    items = [('c', 'ch.xhtml', 'application/xhtml+xml', ''),
             ('ncx', 'toc.ncx', 'application/x-dtbncx+xml', '')]
    _zip(path, [('mimetype', 'application/epub+zip'),
                ('META-INF/container.xml', CONTAINER),
                ('OEBPS/content.opf',
                 _opf('Markup &amp; Entities', items, [('c', '')])),
                ('OEBPS/ch.xhtml', ch),
                ('OEBPS/toc.ncx', ncx)])


def build_malformed(path):
    """Chapters that are not well-formed XML and take the HTML parser:
    a reflowed one (an undefined entity under an XHTML DOCTYPE, unclosed
    p, li and td, upper-case tags, unquoted attributes, a bare '&',
    script and style) and a fixed-layout one."""
    bad = ('<?xml version="1.0" encoding="utf-8"?>\n'
           '<!DOCTYPE html PUBLIC "-//W3C//DTD XHTML 1.1//EN" '
           '"http://www.w3.org/TR/xhtml11/DTD/xhtml11.dtd">\n'
           '<html xmlns="http://www.w3.org/1999/xhtml">\n<head>\n'
           '<title>Bad</title>\n<style>p { margin-left: 10px }</style>\n'
           '<script>if (a < b && c) { x(); }</script>\n</head>\n<body>\n'
           '<H1>Recovered&nbsp;chapter</H1>\n'
           '<P CLASS=lead>One &amp; two & three<BR>four\n'
           '<p>Second <b>bold <i>both</b> tail &copy 2020 &notit;'
           '<!-- c --></p>\n'
           '<ul><li>one<li>two<ul><li>inner</ul><li>three</ul>\n'
           '<table border=1><tr><th>h<td>a<td>b<tr><td>c<td>d</table>\n'
           '<dl><dt>t<dd>d<dt>t2<dd>d2</dl>\n'
           '<p>Image <img src="img/pic.jpg" width=40> after</p>\n'
           '<div>Div text &lt;not a tag&gt;</div>\n</body>\n</html>\n')
    badfix = ('<html xmlns="http://www.w3.org/1999/xhtml"><head>'
              '<meta name="viewport" content="width=300, height=400">'
              '<style>.pic { position:absolute; left:20px; top:40px; '
              'width:100px; height:80px }</style></head><body>'
              '<div style="position:absolute; left:10px; top:10px; '
              'font-size:18px">Fixed&nbsp;<a href="https://example.org/f">'
              'page</a></div><img class=pic src="img/pic.jpg">'
              '<h2>Fixed title</h2></body></html>')
    items = [('c1', 'bad.xhtml', 'application/xhtml+xml', ''),
             ('c2', 'badfix.xhtml', 'application/xhtml+xml', ''),
             ('i1', 'img/pic.jpg', 'image/jpeg', '')]
    _zip(path, [('mimetype', 'application/epub+zip'),
                ('META-INF/container.xml', CONTAINER),
                ('OEBPS/content.opf',
                 _opf('Malformed', items,
                      [('c1', ''),
                       ('c2', 'rendition:layout-pre-paginated')])),
                ('OEBPS/bad.xhtml', bad), ('OEBPS/badfix.xhtml', badfix),
                ('OEBPS/img/pic.jpg', JPEG)])


def build_fixed(path):
    """A pre-paginated book: a viewport page with positioned images,
    text and a link, and an SVG page with a viewBox, an image and
    shapes."""
    p1 = _xhtml(
        '<div style="position:absolute; left:40px; top:30px; '
        'font-size:20px">CAPTION <a href="p2.xhtml">next</a></div>'
        '<div style="position:absolute; left:100px; top:200px">'
        '<img src="art.jpg" style="width:160px; height:120px"/></div>'
        '<img class="art" src="gray.png"/>',
        head='<meta name="viewport" content="width=400, height=600"/>'
             '<style>.art { position: absolute; left: 50px; top: 400px; '
             'width: 100px; height: 60px; }</style>')
    p2 = _xhtml(
        '<svg xmlns="http://www.w3.org/2000/svg" '
        'xmlns:xlink="http://www.w3.org/1999/xlink" viewBox="0 0 300 200" '
        'width="300" height="200"><image xlink:href="art.jpg" x="0" '
        'y="0" width="300" height="200"/><rect x="10" y="10" width="50" '
        'height="30" fill="green"/><line x1="0" y1="0" x2="300" y2="200" '
        'stroke="black" stroke-width="2"/></svg>')
    items = [('p1', 'p1.xhtml', 'application/xhtml+xml', ''),
             ('p2', 'p2.xhtml', 'application/xhtml+xml', 'svg'),
             ('a', 'art.jpg', 'image/jpeg', ''),
             ('g', 'gray.png', 'image/png', '')]
    _zip(path, [('mimetype', 'application/epub+zip'),
                ('META-INF/container.xml', CONTAINER),
                ('OEBPS/content.opf',
                 _opf('Fixed', items, [('p1', ''), ('p2', '')],
                      meta='<meta property="rendition:layout">'
                           'pre-paginated</meta>')),
                ('OEBPS/p1.xhtml', p1), ('OEBPS/p2.xhtml', p2),
                ('OEBPS/art.jpg', JPEG), ('OEBPS/gray.png', _png())])


def _odttf(data, guid):
    """ECMA-388 font obfuscation: the first 32 bytes XORed with the
    part name's GUID bytes in reverse order."""
    key = bytes.fromhex(guid.replace('-', ''))
    return bytes(b ^ key[15 - (i % 16)]
                 for i, b in enumerate(data[:32])) + data[32:]


def build_xps_font(path):
    """An XPS: two fixed pages, glyph runs in an obfuscated embedded font
    (the port's glyphless.ttf) with and without Indices, a canvas
    transform, filled and stroked paths, an image brush, links and core
    properties."""
    guid = '0C1D2E3F-4A5B-6C7D-8E9F-A0B1C2D3E4F5'
    font = 'Resources/%s.odttf' % guid
    with open(GLYPHLESS, 'rb') as fp:
        font_data = fp.read()
    page1 = (
        '<FixedPage xmlns="%s" Width="816" Height="1056" xml:lang="en-US">'
        '<!-- a comment -->'
        '<Path Fill="#FFFF0000" Data="M 0,0 L 816,0 816,48 0,48 Z"/>'
        '<Glyphs OriginX="96" OriginY="192" FontRenderingEmSize="32" '
        'UnicodeString="Hello XPS" Fill="#FF000000" FontUri="/%s" '
        'FixedPage.NavigateUri="https://example.org/xps"/>'
        '<Glyphs OriginX="96" OriginY="260" FontRenderingEmSize="20" '
        'UnicodeString="Kerned" Indices=",120;,90;;,80" FontUri="/%s"/>'
        '<Canvas RenderTransform="1,0,0,1,96,0"><Glyphs OriginX="0" '
        'OriginY="960" FontRenderingEmSize="16" UnicodeString="shifted" '
        'FontUri="/missing.odttf" FixedPage.NavigateUri="2.fpage"/>'
        '</Canvas>'
        '<Path Stroke="#FF0000FF" StrokeThickness="3" '
        'Data="M 100,500 C 200,400 300,600 400,500"/>'
        '<Path Data="M 96,600 L 480,600 480,888 96,888 Z"><Path.Fill>'
        '<ImageBrush ImageSource="/Resources/art.jpg" Viewbox="0,0,32,24" '
        'ViewboxUnits="Absolute" Viewport="96,600,384,288" '
        'ViewportUnits="Absolute"/></Path.Fill></Path></FixedPage>'
        % (XPS_NS, font, font))
    page2 = (
        '<FixedPage xmlns="%s" Width="600" Height="800">'
        '<Glyphs OriginX="50" OriginY="100" FontRenderingEmSize="24" '
        'UnicodeString="Page two" FontUri="/%s"/>'
        '<Path Fill="#FF00AA00"><Path.Data><PathGeometry>'
        '<PathFigure StartPoint="50,200" IsClosed="true">'
        '<PolyLineSegment Points="150,200 100,300"/></PathFigure>'
        '</PathGeometry></Path.Data></Path></FixedPage>' % (XPS_NS, font))
    _zip(path, [
        ('FixedDocSeq.fdseq',
         '<FixedDocumentSequence xmlns="%s"><DocumentReference '
         'Source="/Documents/1/FixedDoc.fdoc"/></FixedDocumentSequence>'
         % XPS_NS),
        ('Documents/1/FixedDoc.fdoc',
         '<FixedDocument xmlns="%s"><PageContent Source="Pages/1.fpage"/>'
         '<PageContent Source="Pages/2.fpage"/></FixedDocument>' % XPS_NS),
        ('Documents/1/Pages/1.fpage', page1),
        ('Documents/1/Pages/2.fpage', page2),
        (font, _odttf(font_data, guid)),
        ('Resources/art.jpg', JPEG),
        ('docProps/core.xml',
         '<cp:coreProperties xmlns:cp="http://schemas.openxmlformats.org/'
         'package/2006/metadata/core-properties" '
         'xmlns:dc="http://purl.org/dc/elements/1.1/">'
         '<dc:title>XPS &amp; Font</dc:title><dc:creator>Auth</dc:creator>'
         '</cp:coreProperties>')])


# case name -> (builder, file extension)
CASES = {
    'reflow': (build_reflow, '.epub'),
    'markup': (build_markup, '.epub'),
    'malformed': (build_malformed, '.epub'),
    'fixed': (build_fixed, '.epub'),
    'xps_font': (build_xps_font, '.xps'),
}

# sha256 of the JAX converter's PDF for each case: 'full' with
# matplotlib's AFMs and fontTools, 'bare' without either
JAX_SHA256 = {
    'fixed': {
        'full': 'f91d870b0a0d1305a80d76447d9a5639927986d67ca065200826c114857eec8d',
        'bare': '54f21726a25032c8f245c7cac18b0d4cb3dca843e760c023fee52ac47d57db7e'},
    'malformed': {
        'full': '986b141aa74215fd37ee874c10f752ef973df91da21e10da3ffca3dc1ffbca14',
        'bare': 'a08462b0b76fc45515af93b8115906b10bf8089293de053c00064d707229b702'},
    'markup': {
        'full': '6500baa3345cea7958e64d6115e17c26113f0e7d42046e9798fd4d792f9f4ef5',
        'bare': '40cb4aaf0677d3582b341eca7a84cbd595993bcac73e01a0a707674dbed59a9e'},
    'reflow': {
        'full': 'db18bbf988a4cae3f68cd3da19fda9bb57a302e27282924733d4f022ea9096ce',
        'bare': '768e7e7bdd7c4014b43909c32453c291e28e6c44c0cb8d1fa19f448109e39500'},
    'xps_font': {
        'full': 'c561e54aba06110780e1d429c5eef64e4a4bed5362aa8c249da6cd76647d5c76',
        'bare': 'dea0689b75c9fba552c8fdae85f72abccdcf5c621b3edcfbef73d78f21ad36c0'},
}


def make_case(name, directory):
    """Build case ``name`` in ``directory``; its path."""
    build, ext = CASES[name]
    path = os.path.join(str(directory), name + ext)
    build(path)
    return path


def environment():
    """'full' when matplotlib and fontTools import, 'bare' when neither
    does (the pins cover those two), None otherwise."""
    have = [importlib.util.find_spec(m) is not None
            for m in ('matplotlib', 'fontTools')]
    return 'full' if all(have) else 'bare' if not any(have) else None


def sha256_of(path):
    with open(path, 'rb') as fp:
        return hashlib.sha256(fp.read()).hexdigest()


# --- the JAX package's EPUB/XPS tests, run through both converters -----

JAX_TEST_MODULES = ('test_epub_layout', 'test_epub_fixed',
                    'test_epub_links', 'test_epub_embedfont', 'test_xps')


def _jax_test_cases():
    """(module, test, parameters) for every test of the JAX modules that
    calls the converter's ``main``, read from their source."""
    out = []
    for mod in JAX_TEST_MODULES:
        with open(os.path.join(TESTS, mod + '.py'), encoding='utf-8') as fp:
            tree = ast.parse(fp.read())
        for node in tree.body:
            if not (isinstance(node, ast.FunctionDef) and
                    node.name.startswith('test_')):
                continue
            if not any(isinstance(c, ast.Call) and
                       getattr(c.func, 'id', None) == 'main'
                       for c in ast.walk(node)):
                continue
            params = [{}]
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call) and \
                        getattr(dec.func, 'attr', None) == 'parametrize':
                    name = ast.literal_eval(dec.args[0])
                    values = ast.literal_eval(dec.args[1])
                    params = [dict(p, **{name: v})
                              for p in params for v in values]
            out += [pytest.param(mod, node.name, p,
                                 id='%s::%s%s' % (mod, node.name, ''.join(
                                     '[%s]' % v for v in p.values())))
                    for p in params]
    return out


def _both(jax_main, port_main, calls):
    """A ``main`` that runs the JAX converter, then the port's on the
    same input into a sibling file, and asserts equal exit codes and
    bytes."""
    def main(argv):
        calls.append(argv)
        src, out = argv[0], argv[1]
        port_out = str(out) + '.port.pdf'
        rc = jax_main([src, out] + list(argv[2:]))
        assert port_main([src, port_out] + list(argv[2:])) == rc
        with open(out, 'rb') as a, open(port_out, 'rb') as b:
            assert a.read() == b.read(), src
        return rc
    return main


@pytest.mark.parametrize('module, test, params', _jax_test_cases())
def test_jax_test_inputs_give_the_same_pdf(module, test, params, tmp_path,
                                           monkeypatch):
    from archive_pdf_tools_tpu.cli.epub_to_pdf import main as jax_main
    from archive_pdf_tools_tpu_torch.cli.epub_to_pdf import main as port_main
    mod = importlib.import_module('tests.' + module)
    calls = []
    monkeypatch.setattr(mod, 'main', _both(jax_main, port_main, calls))
    fn = getattr(mod, test)
    args = {'tmp_path': tmp_path, **params}
    fn(**{k: args[k] for k in inspect.signature(fn).parameters})
    assert calls


# --- this module's own cases --------------------------------------------

@pytest.mark.parametrize('case', sorted(CASES))
def test_own_case_gives_the_jax_bytes(case, tmp_path):
    from archive_pdf_tools_tpu.cli.epub_to_pdf import main as jax_main
    from archive_pdf_tools_tpu_torch.cli.epub_to_pdf import main as port_main
    src = make_case(case, tmp_path)
    assert jax_main([src, str(tmp_path / 'jax.pdf')]) == 0
    assert port_main([src, str(tmp_path / 'port.pdf')]) == 0
    assert sha256_of(tmp_path / 'jax.pdf') == sha256_of(tmp_path / 'port.pdf')
    assert sha256_of(tmp_path / 'jax.pdf') == JAX_SHA256[case][environment()]


# both converters with matplotlib and fontTools blocked, as on a machine
# without them; prints the two digests
_BARE = r'''
import sys
for name in ('matplotlib', 'fontTools'):
    sys.modules[name] = None
sys.path.insert(0, %(root)r)
import importlib.util
spec = importlib.util.spec_from_file_location('own', %(here)r)
own = importlib.util.module_from_spec(spec)
spec.loader.exec_module(own)
from archive_pdf_tools_tpu.cli.epub_to_pdf import main as jax_main
from archive_pdf_tools_tpu_torch.cli.epub_to_pdf import main as port_main
src = own.make_case(%(case)r, %(tmp)r)
for name, main in (('jax', jax_main), ('port', port_main)):
    out = %(tmp)r + '/' + name + '.pdf'
    assert main([src, out]) == 0
    print(name, own.sha256_of(out))
'''


@pytest.mark.parametrize('case', sorted(CASES))
def test_own_case_without_afm_metrics_or_fonttools(case, tmp_path):
    """With neither matplotlib (the standard-14 AFM metrics) nor fontTools
    (embedded fonts) importable, both converters fall back alike."""
    code = _BARE % {'root': ROOT, 'case': case, 'tmp': str(tmp_path),
                    'here': os.path.abspath(__file__)}
    r = subprocess.run([sys.executable, '-c', code], capture_output=True,
                       text=True, timeout=120,
                       env=dict(os.environ, APT_PLATFORM='cpu'))
    assert r.returncode == 0, r.stderr[-2000:]
    digests = dict(line.split() for line in r.stdout.splitlines()
                   if line.startswith(('jax ', 'port ')))
    assert digests['jax'] == digests['port'] == JAX_SHA256[case]['bare']
