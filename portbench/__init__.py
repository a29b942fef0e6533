"""The benchmark of ``advntr_tpu_torch``: loci genotyped per second through
the port's own ``genotype`` entry, on synthetic panels shaped after
adVNTR's default Illumina and PacBio databases.

``run.py`` is the one command.  Everything a cell needs is data found by
name: ``configs/<config>.json`` (the panel), ``traffic/<traffic>.json``
(the sample and the calls), ``workloads/<cell>.json`` (why the cell
exists), and each per-layer metric's reader ``metrics/<metric>.py``.
``reference/`` is the plain NumPy/PyTorch reference that decides
``correct``; it imports nothing of the port.
"""
