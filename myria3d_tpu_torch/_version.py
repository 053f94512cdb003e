"""Single source of the port's version: a copy of ``myria3d_tpu/_version.py``
(the reference's ``myria3d/_version.py:1-5``), printable with
``python -m myria3d_tpu_torch._version``.
"""

__version__ = "0.5.0"

if __name__ == "__main__":
    print(__version__)
