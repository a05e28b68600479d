"""Model FLOPs of a step from the configuration's shapes (the yardstick of
``mfu.*``): every dense product of the forward pass counted once, again
for the weight's gradient where the weight trains, and again for the
input's gradient where the input needs one; the teacher's and an
evaluation's forward once; each aggregation's additions, ``E * D``, forward
and, where its input needs a gradient, backward.  Recomputation is not
counted.  A product of ``[m, k] x [k, n]`` is ``2 m k n``."""

from __future__ import annotations


def mm(m, k, n) -> float:
    return 2.0 * m * k * n


def _encoder(enc: dict, n: int, e: int, trained: bool) -> float:
    """The SAGE stack: two products and one aggregation a layer.  Layer
    1's input is the data, so neither its products nor its aggregation
    pass a gradient back."""
    total, d_in = 0.0, enc["input_dim"]
    for layer in range(enc["num_layers"]):
        d = enc["hidden_dim"]
        passes = 1 + (1 if trained else 0) + (1 if trained and layer else 0)
        total += passes * 2 * mm(n, d_in, d)
        total += (2 if trained and layer else 1) * e * d_in
        d_in = d
    return total


def pretrain_step(conf: dict, n: int, e: int, slots: int) -> float:
    enc, vq = conf["encoder"], conf["vq"]
    dim, heads, cd, codes = (enc["hidden_dim"], vq["heads"],
                             vq["codebook_dim"], vq["codebook_size"])
    ortho = vq.get("orthogonal_reg_max_codes") or codes
    trained = (mm(n, dim, heads * cd) + mm(n, heads * cd, dim)   # VQ
               + heads * mm(ortho, cd, ortho)                    # ortho
               + mm(n, dim, enc["input_dim"])                    # feat
               + mm(n, dim, dim) + 2 * 2.0 * slots * dim         # topo
               + mm(slots, 2 * dim, dim)                         # topo sem
               + mm(n, dim, dim))                                # sem
    scores = heads * mm(n, cd, codes)                            # argmax
    return (_encoder(enc, n, e, True) + 3 * trained + scores
            + _encoder(enc, n, e, False))                        # teacher


def finetune_epoch(conf: dict, n: int, e: int) -> float:
    enc, vq = conf["encoder"], conf["vq"]
    dim, heads, cd, codes = (enc["hidden_dim"], vq["heads"],
                             vq["codebook_dim"], vq["codebook_size"])
    classes = conf["num_classes"]
    project_in = mm(n, dim, heads * cd)          # frozen: no weight grad
    scores = heads * mm(n, cd, codes)
    decoder = mm(n, heads * cd, heads * classes)
    train = (_encoder(enc, n, e, True) + 2 * project_in + scores
             + 3 * decoder)
    evaluation = _encoder(enc, n, e, False) + project_in + scores + decoder
    return train + evaluation
