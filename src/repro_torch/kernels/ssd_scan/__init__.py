from .ops import ssd
from .ref import carry, piece_state, ssd_chunked, ssd_decode_step, ssd_ref
from .ssd_scan import SSDScan, ssd_scan
