"""Bytes of the JBIG2 mask streams in the window's PDFs over their pages,
counted by the benchmark's own parse of the written files."""

from portbench.reference import pdfread


def read(run):
    total = 0
    for path in run.pdfs:
        pdf = pdfread.read(path)
        for num in pdf.offsets:
            obj = pdf.obj_at(num)
            if isinstance(obj, pdfread.Stream) and \
                    obj.dict.get('Filter') == 'JBIG2Decode':
                total += len(obj.raw)
    return total / run.pages if total else None
