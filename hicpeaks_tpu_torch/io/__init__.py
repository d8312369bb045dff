"""Cooler, synthetic-data and bedpe I/O of the port.

Nothing is imported here: ``coolerlite`` needs h5py, which a host that runs
the engines from in-memory bands need not have, so each caller imports the
module it uses.
"""
