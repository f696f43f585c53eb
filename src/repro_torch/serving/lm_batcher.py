"""Continuous-batching LM decode loop (the reference's
``serving/lm_batcher.py``): the serving tier's second tenant, beside the
search planner and executors rather than inside them.

A copy of the reference's behaviour, faults included (ROADMAP Queue 3
item 6): admission overwrites the slot's token with each prompt token in
turn, so only the last prompt token is fed, and every slot decodes at one
position, the longest slot's length, over a cache that admission never
clears, so a new occupant attends over the previous one's entries.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device


class LMContinuousBatcher:
    """Slot-based continuous batching for LM decode (vLLM-style admission,
    greedy sampling): a fixed pool of B cache slots; finished sequences
    free their slot and queued prompts are admitted at the next step.

    The cache lives on ``device`` (the card unless the caller names
    another), in the config's compute type: bf16 for the reference's
    configs, which is the reference's cache; the reference's batcher
    fails on a float32 config, whose updates do not match its bf16 cache.
    ``params`` must be on the same device."""

    def __init__(self, cfg, params, batch_slots: int, max_len: int, eos_id: int = 0,
                 *, device=None):
        from repro_torch.models import transformer

        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params
        self.B = batch_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.caches = transformer.init_cache(cfg, batch_slots, max_len, dtype=cfg.dtype,
                                             device=self.device)
        self.tokens = np.zeros((batch_slots, 1), np.int32)
        self.lengths = np.zeros(batch_slots, np.int32)
        self.active = np.zeros(batch_slots, bool)
        self.seq_outputs: dict[int, list] = {}
        self.next_id = 0
        self.slot_owner = [-1] * batch_slots
        self.queue: list = []
        self._decode = lambda p, t, c, pos: transformer.decode_step(cfg, p, t, c, pos)

    def submit(self, prompt_ids: list) -> int:
        rid = self.next_id
        self.next_id += 1
        self.queue.append((rid, list(prompt_ids)))
        return rid

    def _admit(self):
        for slot in range(self.B):
            if not self.active[slot] and self.queue:
                rid, prompt = self.queue.pop(0)
                # the reference's admission, as it is: each prompt token
                # overwrites the last, and the slot's cache is not cleared
                self.active[slot] = True
                self.slot_owner[slot] = rid
                self.seq_outputs[rid] = []
                self.lengths[slot] = 0
                for tok in prompt:
                    self.tokens[slot, 0] = tok

    def step(self) -> dict:
        """One decode step for all active slots. Returns finished seqs."""
        self._admit()
        if not self.active.any():
            return {}
        pos = int(self.lengths.max())
        tokens = torch.from_numpy(self.tokens.copy()).to(self.device)
        logits, self.caches = self._decode(self.params, tokens, self.caches, pos)
        nxt = logits.argmax(dim=-1).to(torch.int32).cpu().numpy()
        finished = {}
        for slot in range(self.B):
            if not self.active[slot]:
                continue
            tok = int(nxt[slot])
            rid = self.slot_owner[slot]
            self.seq_outputs[rid].append(tok)
            self.tokens[slot, 0] = tok
            self.lengths[slot] += 1
            if tok == self.eos_id or self.lengths[slot] >= self.max_len - 1:
                finished[rid] = self.seq_outputs.pop(rid)
                self.active[slot] = False
                self.slot_owner[slot] = -1
        return finished
