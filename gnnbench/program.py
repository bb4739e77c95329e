"""The system under test as a cell drives it: the port's model and
optimizer over the port's graph, one training step or one forward, and
the loop that replays it.

A configuration's module (``configs/<name>.py``) subclasses ``Program``
with the port's model and the names of its parameters; the step itself
is the port's trainers' (``scripts/train_gat_torch.py`` ``make_step``):
the port's Adam (``utils.training.make_optimizer``) and feature dropout
drawn on the device from a generator the CUDA graph registers.  The loss
is cross entropy over every node, as dgNN's scripts and the JAX bench
take it.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F

__all__ = ["Program", "Replayer"]


class Program:
    """The port's model and optimizer over ``graph`` (the port's Graph, on
    the host, as its build made it), holding ``weights`` (a leaf name ->
    tensor dict the benchmark made).  ``step()`` is one training step and
    ``infer()`` one forward into ``out``; each can be captured into a CUDA
    graph."""

    def __init__(self, cfg: dict, traffic: dict, graph, feats, labels,
                 weights: dict, drop_seed: int, device):
        from dgnn_tpu_torch.utils import make_optimizer

        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.feats, self.labels = feats, labels
        self.graph = self.prepare(graph)
        self.model = self.build_model(feats.shape[1],
                                      int(traffic["n_classes"])).to(device)
        named = dict(self.model.named_parameters())
        self.leaf_params = {leaf: named[self.param_name(leaf)]
                            for leaf in weights}
        if len(self.leaf_params) != len(named):
            raise ValueError("the benchmark's leaves do not cover the "
                             "model's parameters")
        with torch.no_grad():
            for leaf, p in self.leaf_params.items():
                p.copy_(weights[leaf].reshape(p.shape))
        self.drop_gen = torch.Generator(device=device).manual_seed(drop_seed)
        self.opt = make_optimizer(self.model, cfg["lr"], cfg["weight_decay"])
        self.loss = self.out = None
        self.nonfinite = torch.zeros((), dtype=torch.int64, device=device)

    # -- what a configuration gives ------------------------------------
    def prepare(self, graph):
        """The graph the model reads, on the device, from the port's host
        Graph (raw arrays kept): its binned layouts alone."""
        return graph.slim().to(self.device)

    def build_model(self, in_feats: int, n_classes: int):
        raise NotImplementedError

    def param_name(self, leaf: str) -> str:
        raise NotImplementedError

    def logits(self, generator):
        """The model's logits; feature dropout from ``generator`` where
        the model is in training."""
        raise NotImplementedError

    # -- the step --------------------------------------------------------
    def loss_of(self, logits):
        return F.cross_entropy(logits, self.labels)

    def update(self):
        self.opt.step()

    def step(self):
        """One training step: its loss goes to ``loss``, and a loss that is
        not finite adds one to ``nonfinite``."""
        self.model.train()
        self.opt.zero_grad(set_to_none=True)
        loss = self.loss_of(self.logits(self.drop_gen))
        loss.backward()
        self.update()
        self.loss = loss.detach()
        self.nonfinite.add_((~torch.isfinite(self.loss)).long())

    def infer(self):
        """One forward with no gradient and no dropout, into ``out``."""
        self.model.eval()
        with torch.no_grad():
            self.out = self.logits(None)

    # -- what the check reads ----------------------------------------------
    def params(self) -> dict:
        return {k: p.detach().clone() for k, p in self.leaf_params.items()}

    def first_grads(self) -> dict:
        """The gradients the optimizer took in its only step so far, from
        its state: Adam's first moment over (1 - beta1); zero where it has
        taken none."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return {k: self.opt.state[p].get("exp_avg", torch.zeros_like(p))
                .detach() / (1 - b1) for k, p in self.leaf_params.items()}

    def throwaway(self) -> "Program":
        """A copy with its own model, optimizer and dropout generator, to
        warm up on: the kernel library, cuBLAS and the allocator come up
        without a step of this program's own state."""
        from dgnn_tpu_torch.utils import make_optimizer

        twin = copy.copy(self)
        twin.model = copy.deepcopy(self.model)
        named = dict(twin.model.named_parameters())
        twin.leaf_params = {k: named[self.param_name(k)]
                            for k in self.leaf_params}
        twin.opt = make_optimizer(twin.model, self.cfg["lr"],
                                  self.cfg["weight_decay"])
        twin.drop_gen = torch.Generator(device=self.device).manual_seed(0)
        twin.nonfinite = torch.zeros_like(self.nonfinite)
        return twin


class Replayer:
    """``fn()`` captured once into a CUDA graph by the port's ``StepGraph``
    (``warmup`` eager calls first) and replayed; on the CPU, where only the
    tests run a cell, ``fn()`` called in a loop."""

    def __init__(self, fn, device, *, generators=(), warmup: int = 0):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            from dgnn_tpu_torch.utils.timing import StepGraph

            self.graph = StepGraph(fn, self.device, generators=generators,
                                   warmup=warmup)
            self.replay = self.graph.replay
        else:
            for _ in range(warmup):
                fn()
            self.graph = None
            self.replay = lambda n=1: [fn() for _ in range(n)]

    def close(self):
        if self.graph is not None:
            self.graph.close()
