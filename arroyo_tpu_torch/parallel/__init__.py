"""Bin- and key-parallel state of the port: ``ring_panes`` (trailing-window
pane aggregation along the bin axis).  The key-sharded mesh state and
device shuffles of ``arroyo_tpu.parallel`` are not ported (ROADMAP
A.10)."""
