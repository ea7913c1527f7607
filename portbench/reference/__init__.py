"""The plain reference that decides `correct`: the containers and
DEFLATE (`containers.py`), one file a format that a configuration names
(`formats/<format>.py`: `judge(out, item)` and the `zlib9_size(item)`
yardstick), the control encoders (`encoders/<name>.py`:
`encode(item)`) and how a control takes the program's place
(`control.py`).  Standard library and NumPy only; nothing of the
program."""
