"""Host-side utilities of the port.

- ``bids``      — BIDS derivative paths
- ``metadata``  — session CSV logs read into row dicts (stdlib ``csv``), or
                  one log into a pandas DataFrame (``csv2df``)
- ``maps_io``   — T2-map and summary writers
- ``profiling`` — spans, counters and stage timers
- ``dicom``     — the Part-10 reader and its pixel decoders (RLE,
                  JPEG-lossless through the host library of
                  ``csrc/dicom_host.cpp``, 12-bit JPEG through ``jpegdct``,
                  8-bit JPEG and JPEG 2000 through PIL)
- ``jpegll`` / ``jpegdct`` — the T.81 lossless and sequential-DCT codecs
- ``dcm2nifti`` — DICOM series -> NIfTI + BIDS sidecar
- ``ingest``    — stage 1, DICOM -> BIDS tree + session CSVs (pandas),
                  driven by ``cli.dcm2csv``

``ingest`` imports pandas, so it is not imported here.
"""

from .bids import get_img_path, mk_bids_dir
from .metadata import csv2df, read_csv, set_metadata

__all__ = ["get_img_path", "mk_bids_dir", "read_csv", "set_metadata", "csv2df"]
