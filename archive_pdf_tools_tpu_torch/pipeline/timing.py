# Copied from archive_pdf_tools_tpu/pipeline/timing.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""Timing summary + external reporter hook.

Reference: the hand-rolled (stage, seconds) list threaded through every
hot function and summarized per page (``recode.py:237-262``), and the
``--reporter`` subprocess that receives JSON on stdin every N pages
(``recode.py:222-228,501-525,761-763``) for statsd-style ingestion.
"""

import json
import subprocess


def get_timing_summary(timing_data):
    """Average per page (keyed on image_load occurrences), as ms ints
    (``recode.py:237-262``)."""
    sums = {}
    image_load_c = 0
    for key, val in timing_data:
        if key == 'image_load':
            image_load_c += 1
        sums[key] = sums.get(key, 0.0) + val
    denom = max(image_load_c, 1)
    return {k: int(v / denom * 1000) for k, v in sums.items()}


class Reporter:
    """Sends JSON blobs to a reporter program's stdin
    (``recode.py:228,508``).  Accepts a command string or argv list."""

    def __init__(self, command):
        if isinstance(command, str):
            command = command.split(' ')
        self.command = command or None

    def __bool__(self):
        return self.command is not None

    def send(self, payload):
        if not self.command:
            return
        data = json.dumps(payload)
        subprocess.check_output(self.command, input=data.encode('utf-8'))
