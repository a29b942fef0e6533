"""Host Viterbi over a compiled artifact.

Counterpart of ``viterbi_numpy`` in advntr_tpu/ops/viterbi.py: the float64
single-read decoder that the repeat finder of
``models/reference_vntr.py`` runs on the host.  The batched device
decoders of this package live in ``ops/viterbi_fused.py``.
"""

from __future__ import annotations

import numpy as np


def viterbi_numpy(art, codes: np.ndarray):
    """Single-read float64 Viterbi over a compiled artifact.

    Returns (logp, path) where path is the emitting-state index sequence.
    """
    log_T, log_E = art.log_T, art.log_E
    n = art.n_states
    L = len(codes)
    v = art.log_start + log_E[:, codes[0]]
    args = np.zeros((L, n), dtype=np.int32)
    for t in range(1, L):
        scores = v[:, None] + log_T
        args[t] = np.argmax(scores, axis=0)
        v = scores[args[t], np.arange(n)] + log_E[:, codes[t]]
    final = v + art.log_end
    end_state = int(np.argmax(final))
    logp = final[end_state]
    if not np.isfinite(logp):
        return float(logp), None
    path = np.zeros(L, dtype=np.int32)
    cur = end_state
    for t in range(L - 1, -1, -1):
        path[t] = cur
        if t > 0:
            cur = args[t][cur]
    return float(logp), path
