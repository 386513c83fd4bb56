"""Train a GCN with Degree-Quant QAT, then deploy it int8: the PyTorch port.

    PYTHONPATH=src python examples/train_gcn_degreequant_torch.py [--steps 300] [--device cpu]

The port of ``examples/train_gcn_degreequant.py`` (the paper's quantization
workflow, §2.3.1), with its data, loss, optimiser and accuracies: train with
stochastic degree-based protection masks (protected nodes stay float, the
rest are fake-quantized with the STE), then deploy int8 through the
mixed-precision engine and report the accuracy cost of quantization, the
quantity Degree-Quant minimizes. Labels come from a planted
feature/community model, so accuracy is meaningful.

It runs on the card by default (``--device cpu`` runs the kernels' plain
versions). There, each step's two aggregations launch the AGE kernel and
the backward launches it once more, on the transposed plan
(``AmpleEngine.aggregate``); the deployed model launches the AGE and the
int8 GEMM kernels. The weights come from a ``torch.Generator`` of
``--seed``; the protection masks from numpy, as in the reference.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse
import torch

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.degree_quant import DegreeQuantConfig, sample_protection_mask
from repro_torch.core.message_passing import AmpleEngine, EngineConfig
from repro_torch.core.quantization import compute_scale_zp, fake_quant
from repro_torch.device import resolve_device
from repro_torch.graphs.csr import Graph, add_self_loops
from repro_torch.graphs.datasets import make_dataset
from repro_torch.models.gnn import gcn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

NUM_CLASSES = 7
DQ = DegreeQuantConfig(p_min=0.0, p_max=0.2)
WEIGHT_DECAY = 5e-3


def planted_labels(g: Graph, num_classes: int, seed: int) -> np.ndarray:
    """Labels = argmax over class prototypes of (features + neighbor mean).

    The neighbour sum is a CSR product (scipy sums each row's neighbours in
    edge order, in f32, as the reference's ``np.add.at`` does), so the
    labels are the reference's, and a 14.7 M-edge graph takes seconds.
    """
    rng = np.random.default_rng(seed)
    proto = rng.standard_normal((g.feature_dim, num_classes)).astype(np.float32)
    x = g.features
    deg = np.maximum(g.degrees, 1)
    adj = scipy.sparse.csr_matrix(
        (np.ones(g.num_edges, np.float32), g.indices, g.indptr),
        shape=(g.num_nodes, g.num_nodes))
    agg = adj @ x
    smooth = x + agg / deg[:, None]
    return np.argmax(smooth @ proto, axis=1).astype(np.int32)


def node_task(g: Graph, num_classes: int) -> Tuple[np.ndarray, np.ndarray]:
    """(labels, train mask) of a graph with features: planted labels (seed
    1), a random half of the nodes for training (seed 2)."""
    labels = planted_labels(g, num_classes, seed=1)
    train_mask = np.zeros(g.num_nodes, bool)
    train_mask[np.random.default_rng(2).permutation(g.num_nodes)[: g.num_nodes // 2]] = True
    return labels, train_mask


def qat_loss(params: Dict, engine: AmpleEngine, x: torch.Tensor, labels: torch.Tensor,
             train_mask: torch.Tensor, protect_mask: torch.Tensor) -> torch.Tensor:
    """QAT forward: unprotected node activations are fake-quantized."""
    def fq(h):
        qp = compute_scale_zp(h, symmetric=True)
        return torch.where(protect_mask[:, None], h, fake_quant(h, qp))

    h = fq(x)
    m = engine.aggregate(h, mode="gcn")
    h = torch.relu(m @ params["layers"][0]["w"])
    h = fq(h)
    m = engine.aggregate(h, mode="gcn")
    logits = m @ params["layers"][1]["w"]
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, 1, labels[:, None])[:, 0]
    return torch.where(train_mask, nll, 0.0).sum() / train_mask.sum()


def qat_grads(params: Dict, engine: AmpleEngine, x, labels, train_mask,
              protect_mask) -> Tuple[torch.Tensor, Dict]:
    """(loss, gradients shaped like ``params``) of ``qat_loss``."""
    loss = qat_loss(params, engine, x, labels, train_mask, protect_mask)
    grads = torch.autograd.grad(loss, [lyr["w"] for lyr in params["layers"]])
    return loss, {"layers": [{"w": gw} for gw in grads]}


def trainable(params: Dict) -> Dict:
    """GCN params as leaves that require grad."""
    return {"layers": [{"w": lyr["w"].detach().requires_grad_()} for lyr in params["layers"]]}


def train(params: Dict, engine: AmpleEngine, x: torch.Tensor, labels: torch.Tensor,
          train_mask: torch.Tensor, *, steps: int, lr: float,
          rng: Optional[np.random.Generator] = None,
          log_every: int = 0) -> Tuple[Dict, List[float]]:
    """``steps`` AdamW steps on ``qat_loss`` with a fresh protection mask
    each step (numpy ``rng``, seed 3 when omitted). Returns the params and
    each step's loss."""
    params = trainable(params)
    opt_cfg = AdamWConfig(lr=lr, weight_decay=WEIGHT_DECAY)
    opt = adamw_init(params)
    rng = np.random.default_rng(3) if rng is None else rng
    losses = []
    t0 = time.time()
    for step in range(steps):
        mask = torch.from_numpy(sample_protection_mask(engine.graph, DQ, rng)).to(x.device)
        loss, grads = qat_grads(params, engine, x, labels, train_mask, mask)
        params, opt, _ = adamw_update(grads, opt, params, opt_cfg)
        losses.append(loss.detach())
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1:4d}  qat_loss {float(losses[-1]):.4f}  "
                  f"({time.time() - t0:.1f}s)")
    return params, [float(v) for v in losses]


@torch.no_grad()
def evaluate(cfg: ModelConfig, params: Dict, engine: AmpleEngine, x: torch.Tensor,
             labels: torch.Tensor, test_mask: torch.Tensor) -> Tuple[float, float]:
    """(float, deployed int8) test accuracy: ``gcn.apply`` on the float
    training engine, then on a mixed-precision engine of the same graph."""
    def accuracy(eng):
        pred = torch.argmax(gcn.apply(cfg, params, eng, x), dim=-1)
        return float((pred == labels)[test_mask].to(torch.float32).mean())

    acc_float = accuracy(engine)
    return acc_float, accuracy(AmpleEngine(engine.graph, EngineConfig(mixed_precision=True)))


def example_model(g: Graph) -> ModelConfig:
    """The example's GCN: reduced, at the graph's feature width, 7 classes."""
    return dataclasses.replace(get_config("ample-gcn", reduced=True),
                               d_model=g.feature_dim, d_ff=32, vocab_size=NUM_CLASSES)


def example_graph(nodes: int) -> Graph:
    """Synthetic cora cut to ``nodes`` at 128 features, with self-loops."""
    base = make_dataset("cora", max_nodes=nodes, max_feature_dim=128, seed=0)
    return add_self_loops(base).with_features(base.features)


def run(*, steps: int, nodes: int, lr: float, device, seed: int = 0,
        log_every: int = 0) -> Dict[str, float]:
    """The example end to end on ``device``: its accuracies and losses."""
    dev = resolve_device(device)
    g = example_graph(nodes)
    labels_np, train_np = node_task(g, NUM_CLASSES)
    x = torch.from_numpy(g.features).to(dev)
    labels = torch.from_numpy(labels_np).long().to(dev)
    train_mask = torch.from_numpy(train_np).to(dev)
    cfg = example_model(g)
    params = gcn.init(cfg, torch.Generator().manual_seed(seed), dev)
    eng = AmpleEngine(g, EngineConfig(mixed_precision=False))
    params, losses = train(params, eng, x, labels, train_mask, steps=steps, lr=lr,
                           log_every=log_every)
    acc_float, acc_mixed = evaluate(cfg, params, eng, x, labels, ~train_mask)
    return {"acc_float": acc_float, "acc_mixed": acc_mixed, "first_loss": losses[0],
            "last_loss": losses[-1]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--nodes", type=int, default=800)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0, help="torch.Generator seed of the weights")
    args = ap.parse_args()
    res = run(steps=args.steps, nodes=args.nodes, lr=args.lr, device=args.device,
              seed=args.seed, log_every=50)
    print(f"\ntest accuracy  float32: {res['acc_float']:.3f}   "
          f"mixed int8/float (deployed): {res['acc_mixed']:.3f}   "
          f"quantization cost: {res['acc_float'] - res['acc_mixed']:+.3f}")


if __name__ == "__main__":
    main()
