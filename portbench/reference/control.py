"""The controls: what must come out as not correct.

The configurations state no precision, so each control breaks one
guarantee its configuration states (`controls` in its file, by name):
- "reference": a plain encoder in the program's place, named by its
  `encoder` and found in `encoders/` (`encode(item) -> bytes`), such as
  zlib at level 9 framed as gzip with the CRC-32 left 0, or zlib at
  level 9 with sound framing;
- "program": the program itself with options changed, such as fewer
  iterations.
"""

from __future__ import annotations

from portbench.manifest import Manifest


def entry(call: str, config: dict, program_entry, name: str,
          man: Manifest | None = None):
    """run(items) -> outputs of the configuration's control `name`; a
    reference control's encoder is `reference/encoders/<encoder>.py`
    under `man`'s bench dir (the benchmark's own by default)."""
    c = config["controls"][name]
    if c["kind"] == "reference":
        enc = (man or Manifest()).module("reference/encoders",
                                         c["encoder"]).encode
        return lambda items: [enc(i) for i in items]
    if c["kind"] == "program":
        changed = dict(config, options={**config.get("options", {}),
                                        **c["options"]})
        return program_entry(call, changed)
    raise ValueError(f"unknown control kind {c['kind']!r}")
