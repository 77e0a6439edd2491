"""Interop IO: readers/writers for the reference's binary DB formats.

Counterpart of hmmufotu_tpu/io/__init__.py, on this package's modules.
npz.py (the port's own) writes and reads the DB's npz files on every
host core.
"""

from .reference_format import (load_reference_csfm, load_reference_msa,
                               load_reference_ptu, save_reference_csfm,
                               save_reference_msa, save_reference_ptu,
                               load_reference_db, save_reference_db)
