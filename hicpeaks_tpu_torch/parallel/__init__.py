"""Multi-device and multi-process runs (port of ``hicpeaks_tpu/parallel``):
the tile mesh (:mod:`.mesh`), band tiles with halos (:mod:`.tiles`), the
process group (:mod:`.launch`) and the chromosome and tile strategies
across processes (:mod:`.multihost`)."""
