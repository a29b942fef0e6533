"""DNN read recruitment (adVNTR-NN): a per-locus MLP that pre-screens
unmapped reads, so that Viterbi runs only on likely candidates.

Counterpart of advntr_tpu/engine/deep_recruitment.py in PyTorch: a read's
embedding is its binary 6-mer presence vector (4^6 = 4,096 inputs), the
model Dense(100, relu) [-> Dense(50, relu)] -> Dense(2, softmax), class 0
a VNTR read.  Training is Adam on the reference's loss, in the
reference's batch order.  Checkpoints are ``.npz`` files with the
reference's keys (``w1 (4096, 100)``, ``b1``, ``w2``, ``b2``,
``w_out (., 2)``, ``b_out``), so a file either package wrote is read by
the other.  The reference computes all of this as plain XLA (no Pallas),
so here it is plain PyTorch, in full float32 (no TF32: a TF32 product can
flip a decision near 0.5).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from advntr_tpu_torch.device import full_float32_matmul

KMER_LENGTH = 6
INPUT_DIM = 4 ** KMER_LENGTH

# parameter names in layer order, as the reference's dict holds them
PARAM_NAMES = ("w1", "b1", "w2", "b2", "w_out", "b_out")


def embed_batch(seqs, lengths, device) -> torch.Tensor:
    """Binary 6-mer presence embeddings (B, 4096) float32 on ``device``
    (deep_recruitment.py:25-47).

    seqs: (B, L) codes; non-ACGT bases count as A (code 0), the
    reference's quirk; 6-mers starting past ``length - 6`` are masked."""
    s = torch.as_tensor(seqs, device=device).long()
    lengths = torch.as_tensor(lengths, device=device).long()
    B, L = s.shape
    out = torch.zeros((B, INPUT_DIM), dtype=torch.float32, device=device)
    n_pos = L - KMER_LENGTH + 1
    if n_pos <= 0:
        return out
    s = torch.where(s < 4, s, 0)
    code = torch.zeros((B, n_pos), dtype=torch.long, device=device)
    for j in range(KMER_LENGTH):
        code = code * 4 + s[:, j:j + n_pos]
    pos_ok = torch.arange(n_pos, device=device)[None, :] <= \
        (lengths[:, None] - KMER_LENGTH)
    return out.scatter_reduce_(1, code, pos_ok.float(), reduce="amax")


class RecruitmentMLP(torch.nn.Module):
    """Dense(first, relu) [-> Dense(second, relu)] -> Dense(2, softmax),
    with the reference's parameter names and (in, out) layouts."""

    def __init__(self, first_layer: int = 100, second_layer: int = 0):
        super().__init__()
        shapes = {"w1": (INPUT_DIM, first_layer), "b1": (first_layer,)}
        prev = first_layer
        if second_layer:
            shapes.update(w2=(prev, second_layer), b2=(second_layer,))
            prev = second_layer
        shapes.update(w_out=(prev, 2), b_out=(2,))
        for name, shape in shapes.items():
            self.register_parameter(
                name, torch.nn.Parameter(torch.zeros(shape)))

    @property
    def has_second_layer(self) -> bool:
        return hasattr(self, "w2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(x @ self.w1 + self.b1)
        if self.has_second_layer:
            h = torch.relu(h @ self.w2 + self.b2)
        return torch.softmax(h @ self.w_out + self.b_out, dim=-1)

    @classmethod
    def from_numpy(cls, params: dict, device="cpu") -> "RecruitmentMLP":
        """The module of a reference parameter dict (numpy or jax arrays,
        or an ``.npz``'s contents): the weight-carry function."""
        params = {k: np.asarray(params[k], dtype=np.float32)
                  for k in PARAM_NAMES if k in params}
        model = cls(params["w1"].shape[1],
                    params["w2"].shape[1] if "w2" in params else 0)
        with torch.no_grad():
            for name, value in params.items():
                getattr(model, name).copy_(torch.tensor(value))
        return model.to(device)

    def to_numpy(self) -> dict:
        """The reference's parameter dict: name -> float32 numpy array."""
        return {name: p.detach().cpu().numpy()
                for name, p in self.named_parameters()}


def init_params(first_layer: int = 100, second_layer: int = 0,
                generator: torch.Generator | None = None) -> RecruitmentMLP:
    """Weights uniform in [-0.05, 0.05), zero biases (the reference's
    ``init_params``; its draws come from jax.random, these from
    ``generator``), on the CPU."""
    model = RecruitmentMLP(first_layer, second_layer)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("w"):
                p.uniform_(-0.05, 0.05, generator=generator)
    return model


def predict(model: RecruitmentMLP, embeddings) -> torch.Tensor:
    """(B, 2) softmax scores on the model's device; class 0 is a VNTR read
    (deep_recruitment.py:78-82)."""
    device = next(model.parameters()).device
    x = torch.as_tensor(embeddings, dtype=torch.float32, device=device)
    with torch.no_grad(), full_float32_matmul():
        return model(x)


def train(embeddings, labels, epochs: int = 3, batch_size: int = 10,
          learning_rate: float = 1e-3, second_layer: int = 0, seed: int = 0,
          device="cuda") -> RecruitmentMLP:
    """Train from ``init_params`` on ``device`` (deep_recruitment.py:
    85-114); labels are 1 for VNTR reads, 0 for decoys.  The loss is the
    reference's (the mean over the batch of the two classes' binary cross
    entropies, 1e-9 inside each log); the batches follow
    ``np.random.default_rng(seed)``'s permutation of each epoch, as there;
    the optimiser is ``adam``."""
    device = torch.device(device)
    model = init_params(second_layer=second_layer,
                        generator=torch.Generator().manual_seed(seed))
    model = model.to(device)
    x_all = embeddings if torch.is_tensor(embeddings) else \
        torch.tensor(np.asarray(embeddings, dtype=np.float32))
    x_all = x_all.to(device=device, dtype=torch.float32)
    labels = np.asarray(labels)
    onehot = torch.as_tensor(
        np.stack([labels, 1 - labels], axis=1).astype(np.float32),
        device=device)
    opt = adam(model, learning_rate)
    n = len(labels)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n, batch_size):
            idx = torch.as_tensor(order[i:i + batch_size], device=device)
            adam_step(model, opt, x_all[idx], onehot[idx])
    return model


def adam(model: RecruitmentMLP, learning_rate: float = 1e-3):
    """Adam with optax's defaults (betas 0.9, 0.999, eps 1e-8)."""
    return torch.optim.Adam(model.parameters(), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def adam_step(model: RecruitmentMLP, opt, x: torch.Tensor,
              y: torch.Tensor) -> torch.Tensor:
    """One step on a batch: the reference's loss (deep_recruitment.py:
    96-100), its gradient, the update.  Returns the loss."""
    with full_float32_matmul():
        probs = model(x)
        loss = -torch.mean(torch.sum(
            y * torch.log(probs + 1e-9)
            + (1 - y) * torch.log(1 - probs + 1e-9), dim=-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
    return loss.detach()


def save_model(model: RecruitmentMLP, path: str) -> None:
    """An ``.npz`` with the reference's keys."""
    np.savez(path, **model.to_numpy())


def load_model(path: str) -> RecruitmentMLP | None:
    """The module of an ``.npz`` either package wrote, on the CPU; None
    when the file is absent."""
    if not os.path.exists(path):
        return None
    with np.load(path) as data:
        return RecruitmentMLP.from_numpy({k: data[k] for k in data.files})
