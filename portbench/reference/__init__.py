"""The plain reference that decides `correct`: containers and DEFLATE
(`containers.py`) and the control encoders
(`control.py`).  Standard library and NumPy only; nothing of the
program."""
