from .ops import ssd
from .ref import ssd_chunked, ssd_decode_step, ssd_ref
from .ssd_scan import SSDScan, ssd_scan
