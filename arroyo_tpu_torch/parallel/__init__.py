"""Bin- and key-parallel state of the port: ``ring_panes`` (trailing-window
pane aggregation along the bin axis), ``mesh_window`` (window state
sharded by key over a list of devices) and ``shuffle`` (shuffle edges as
device exchanges over that list, the resharding counter)."""
