"""DPM structures: the CLHT index (clht.py) and the log segment and value
heap (log.py)."""
