from .bids import get_img_path, mk_bids_dir
from .metadata import read_csv, set_metadata

__all__ = ["get_img_path", "mk_bids_dir", "read_csv", "set_metadata"]
