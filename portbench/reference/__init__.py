"""The plain reference that decides ``correct``: adVNTR's read-matcher
profile HMM built from the database rows, Viterbi over the full graph
(silent states kept) in float64, the path statistics, keyword
recruitment, flank anchoring and the diploid genotype, in NumPy and plain
PyTorch.  It imports nothing of the program and takes nothing the program
made."""
