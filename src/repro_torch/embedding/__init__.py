"""Hot-row selective replication of embedding tables (hot_rows.py)."""

from .hot_rows import (HotRowState, build_replica, lookup,
                       refresh_after_update, select_cold_rows,
                       select_hot_rows)
