"""Cooler, TXT, synthetic-data and bedpe I/O of the port.

``h5lite`` reads and writes the HDF5 subset that coolers use with numpy and
zlib, and ``coolerlite`` is the cooler schema on top of it: no module here
needs h5py.  Nothing is imported here; each caller imports the module it
uses.
"""
