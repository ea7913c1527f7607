"""The controls: what must come out as not correct.

The configurations state no precision, so each control breaks one
guarantee its configuration states (`controls` in its file, by name):
- "reference": a plain encoder in the program's place: zlib at level 9
  framed as gzip with the CRC-32 left 0, the step a change that skips
  the checksum to save host time would take; or zlib at level 9 with
  sound framing, the step a change that gives up bytes for speed would
  take to its end;
- "program": the program itself with options changed, such as fewer
  iterations.
"""

from __future__ import annotations

import struct
import zlib


def gzip_crc_dropped(raw: bytes) -> bytes:
    c = zlib.compressobj(9, zlib.DEFLATED, -15)
    body = c.compress(raw) + c.flush()
    return (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x02\xff" + body
            + struct.pack("<II", 0, len(raw) & 0xFFFFFFFF))


def gzip_zlib9(raw: bytes) -> bytes:
    c = zlib.compressobj(9, zlib.DEFLATED, 31)
    return c.compress(raw) + c.flush()


ENCODERS = {"gzip_crc_dropped": gzip_crc_dropped, "gzip_zlib9": gzip_zlib9}


def entry(call: str, config: dict, program_entry, name: str):
    """run(items) -> outputs of the configuration's control `name`."""
    c = config["controls"][name]
    if c["kind"] == "reference":
        enc = ENCODERS[c["encoder"]]
        return lambda items: [enc(i.raw) for i in items]
    if c["kind"] == "program":
        changed = dict(config, options={**config.get("options", {}),
                                        **c["options"]})
        return program_entry(call, changed)
    raise ValueError(f"unknown control kind {c['kind']!r}")
