"""Train the grapheme→phoneme fallback model on the card (the flags of
``python -m smart_nar_fast_tts_tpu.cli.train_g2p`` plus ``--device``)::

    python -m smart_nar_fast_tts_tpu_torch.cli.train_g2p \\
        [--lexicon PATH] [--out PATH] [--epochs N] [--no-augment] \\
        [--device cpu]

The model of ``text/g2p_model.py``: a char-level bidirectional GRU encoder
→ GRU decoder with Luong attention, teacher-forced cross-entropy, Adam.
Words are split train/held-out by hash, so the reported phoneme error rate
(PER) is on unseen words.  The data helpers are copies of the JAX CLI's;
the loss is its ``make_loss_fn`` formula for formula, on tensors; the same
``np.random.default_rng(seed)`` draws give the same initial weights and
batches.  The parameters live on CUDA unless ``--device cpu`` is given;
the ``.npz`` write and the PER run on the host through the numpy
``G2PModel``.

Defaults train on the committed seed lexicon with morphological
augmentation and write ``g2p_model.TRAINED_WEIGHTS`` (inside this package,
never into the JAX package), which ``text.g2p.G2P`` then picks up.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

from ..text import g2p_model
from ..text.g2p_model import (BOS, DEFAULT_SEED_LEXICON, EOS, G2IDX, P2IDX,
                              PHONEMES)

# -- data ---------------------------------------------------------------------

_SIBILANT = {"S", "Z", "SH", "ZH", "CH", "JH"}
_VOICELESS = {"P", "T", "K", "F", "TH", "S", "SH", "CH", "HH"}
_VOWEL_LETTERS = set("aeiou")


def _base(phone: str) -> str:
    return phone.rstrip("0123456789")


def _plural(word: str, phones: list[str]) -> tuple[str, list[str]]:
    """Regular plural / 3rd-person -s with voicing assimilation."""
    last = _base(phones[-1])
    if last in _SIBILANT:
        if word.endswith(("s", "sh", "ch", "x", "z")):
            w = word + "es"
        else:
            w = word + "s"
        return w, phones + ["IH0", "Z"]
    if word.endswith("y") and len(word) > 2 \
            and word[-2] not in _VOWEL_LETTERS:
        return word[:-1] + "ies", phones + ["Z"]
    tail = ["S"] if last in _VOICELESS else ["Z"]
    return word + "s", phones + tail


def _past(word: str, phones: list[str]) -> tuple[str, list[str]]:
    """Regular past -ed with voicing assimilation."""
    last = _base(phones[-1])
    if word.endswith("e"):
        w = word + "d"
    elif word.endswith("y") and len(word) > 2 \
            and word[-2] not in _VOWEL_LETTERS:
        w = word[:-1] + "ied"
    else:
        w = word + "ed"
    if last in ("T", "D"):
        return w, phones + ["IH0", "D"]
    if last in _VOICELESS:
        return w, phones + ["T"]
    return w, phones + ["D"]


def _ing(word: str, phones: list[str]) -> tuple[str, list[str]]:
    w = word[:-1] + "ing" if word.endswith("e") and not word.endswith("ee") \
        else word + "ing"
    return w, phones + ["IH0", "NG"]


def augment(pairs: dict[str, list[str]]) -> dict[str, list[str]]:
    """Morphological expansion: regular inflections with phonologically
    correct suffix realizations (voicing assimilation, y→ie, silent-e).
    Only applied where orthography is unambiguous (no CVC doubling cases)."""
    out = dict(pairs)

    def _cvc(word: str) -> bool:
        # final consonant doubling candidates (run→running) are skipped:
        # their orthographic rule needs stress knowledge we don't model
        return (len(word) >= 2 and word[-1] not in _VOWEL_LETTERS
                and word[-1] not in "wxy"
                and word[-2] in _VOWEL_LETTERS
                and (len(word) < 3 or word[-3] not in _VOWEL_LETTERS))

    for word, phones in pairs.items():
        if not word.isalpha() or len(word) < 3 or len(phones) < 2:
            continue
        last = _base(phones[-1])
        if last not in {"B", "CH", "D", "DH", "F", "G", "JH", "K", "L",
                        "M", "N", "NG", "P", "R", "S", "SH", "T", "TH",
                        "V", "Z", "ZH"}:
            continue          # suffixing vowel-final words is less regular
        for fn in (_plural, _past, _ing):
            if fn in (_past, _ing) and _cvc(word):
                continue
            w, p = fn(word, phones)
            out.setdefault(w, p)
    return out


def load_pairs(path: str) -> dict[str, list[str]]:
    pairs: dict[str, list[str]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";"):
                continue
            parts = line.split()
            word, phones = parts[0].lower(), parts[1:]
            if all(c in G2IDX for c in word) \
                    and all(p in P2IDX for p in phones):
                pairs.setdefault(word, phones)
    return pairs


def split_heldout(pairs: dict[str, list[str]], frac: float = 0.08
                  ) -> tuple[dict, dict]:
    """Deterministic hash split so held-out words never leak into train."""
    train, held = {}, {}
    for w, p in pairs.items():
        h = int(hashlib.md5(w.encode()).hexdigest(), 16) % 1000
        (held if h < frac * 1000 else train)[w] = p
    return train, held


def encode_batch(words, phones_list, max_w: int, max_p: int):
    B = len(words)
    x = np.zeros((B, max_w), np.int32)
    x_len = np.zeros((B,), np.int32)
    y = np.zeros((B, max_p), np.int32)
    y_len = np.zeros((B,), np.int32)
    for i, (w, ph) in enumerate(zip(words, phones_list)):
        xi = [G2IDX[BOS]] + [G2IDX[c] for c in w] + [G2IDX[EOS]]
        yi = [P2IDX[BOS]] + [P2IDX[p] for p in ph] + [P2IDX[EOS]]
        xi, yi = xi[:max_w], yi[:max_p]
        x[i, :len(xi)] = xi
        x_len[i] = len(xi)
        y[i, :len(yi)] = yi
        y_len[i] = len(yi)
    return x, x_len, y, y_len


# -- model (the training twin of text/g2p_model.py) ---------------------------

def init_params(rng: np.random.Generator, n_g: int, n_p: int,
                emb: int = 64, hidden: int = 128) -> dict:
    def mat(*shape):
        scale = 1.0 / np.sqrt(shape[0])
        return rng.uniform(-scale, scale, shape).astype(np.float32)

    p = {"char_emb": mat(n_g, emb), "phone_emb": mat(n_p, emb)}
    for prefix, xdim in (("enc_fwd_", emb), ("enc_bwd_", emb),
                         ("dec_", emb)):
        for gate in "rzn":
            p[prefix + f"Wx{gate}"] = mat(xdim, hidden)
            p[prefix + f"Wh{gate}"] = mat(hidden, hidden)
            p[prefix + f"b{gate}"] = np.zeros(hidden, np.float32)
    p["Winit"] = mat(2 * hidden, hidden)
    p["binit"] = np.zeros(hidden, np.float32)
    p["Wa"] = mat(2 * hidden, hidden)
    p["Wo"] = mat(3 * hidden, n_p)
    p["bo"] = np.zeros(n_p, np.float32)
    return p


def make_loss_fn():
    """``loss_fn(p, x, x_len, y, y_len)``: the masked teacher-forced NLL of
    JAX's ``make_loss_fn`` on tensors (``p`` a dict of parameters, the
    batch as integer tensors on their device).  Each cell's input
    projections of all steps are one product before its loop and its three
    gates one product a step; the output layer is one product after the
    decoder's loop."""
    import torch
    import torch.nn.functional as F

    def gates(p, prefix, which):
        return torch.cat([p[prefix + f"{which}{g}"] for g in "rzn"], -1)

    def run_gru(p, prefix, xs, h, valid=None, reverse=False):
        """The cell over ``xs`` (T, B, E) from ``h``; with ``valid``
        (T, B) a padded step keeps ``h``.  Returns the states (T, B, H)."""
        xw = xs @ gates(p, prefix, "Wx")               # (T, B, 3H)
        wh = gates(p, prefix, "Wh")
        br, bz, bn = (p[prefix + f"b{g}"] for g in "rzn")
        H = h.shape[-1]
        order = range(xs.shape[0] - 1, -1, -1) if reverse \
            else range(xs.shape[0])
        out = [None] * xs.shape[0]
        for t in order:
            xr, xz, xn = xw[t].split(H, -1)
            hr, hz, hn = (h @ wh).split(H, -1)
            r = torch.sigmoid(xr + hr + br)
            z = torch.sigmoid(xz + hz + bz)
            n = torch.tanh(xn + r * hn + bn)
            h2 = (1.0 - z) * n + z * h
            h = h2 if valid is None else torch.where(valid[t, :, None], h2,
                                                     h)
            out[t] = h
        return torch.stack(out)

    def loss_fn(p, x, x_len, y, y_len):
        B, Lw = x.shape
        H = p["Winit"].shape[1]
        # F.embedding: its backward sums the rows deterministically,
        # where indexing's backward (index_put_ accumulate) does not
        emb = F.embedding(x.long(), p["char_emb"]).transpose(0, 1)
        x_valid = torch.arange(Lw, device=x.device)[None, :] < x_len[:, None]
        h0 = torch.zeros(B, H, device=emb.device)
        fwd = run_gru(p, "enc_fwd_", emb, h0, x_valid.T)
        bwd = run_gru(p, "enc_bwd_", emb, h0, x_valid.T, reverse=True)
        enc = torch.cat([fwd, bwd], -1).transpose(0, 1)  # (B, Lw, 2H)
        enc = torch.where(x_valid[:, :, None], enc, 0.0)

        # decoder init from each item's final valid encoder state
        last = enc[torch.arange(B, device=x.device), x_len.long() - 1]
        h_dec0 = torch.tanh(last @ p["Winit"] + p["binit"])
        keys = enc @ p["Wa"]                             # (B, Lw, H)

        y_in, y_tgt = y[:, :-1], y[:, 1:]
        Ld = y_in.shape[1]
        dec_emb = F.embedding(y_in.long(), p["phone_emb"]).transpose(
            0, 1)                                        # (Ld, B, E)
        hs = run_gru(p, "dec_", dec_emb, h_dec0)         # (Ld, B, H)
        score = torch.einsum("blh,tbh->tbl", keys, hs)
        score = torch.where(x_valid[None], score, -1e9)
        attn = torch.softmax(score, -1)
        ctx = torch.einsum("tbl,blh->tbh", attn, enc)
        logits = (torch.cat([hs, ctx], -1) @ p["Wo"] + p["bo"]).transpose(
            0, 1)                                        # (B, Ld, V)

        tgt_valid = torch.arange(Ld, device=x.device)[None, :] \
            < (y_len - 1)[:, None]
        logp = torch.log_softmax(logits, -1)
        nll = -torch.gather(logp, -1, y_tgt[..., None].long())[..., 0]
        return torch.where(tgt_valid, nll, 0.0).sum() \
            / tgt_valid.sum().clamp(min=1)

    return loss_fn


def phoneme_error_rate(model, pairs: dict[str, list[str]],
                       ignore_stress: bool = True) -> float:
    """Levenshtein phone edit distance / reference length, corpus level."""
    def norm(seq):
        return [_base(p) for p in seq] if ignore_stress else list(seq)

    total_edits, total_len = 0, 0
    for w, ref in pairs.items():
        hyp = norm(model.predict(w))
        ref = norm(ref)
        d = np.zeros((len(hyp) + 1, len(ref) + 1), np.int32)
        d[:, 0] = np.arange(len(hyp) + 1)
        d[0, :] = np.arange(len(ref) + 1)
        for i in range(1, len(hyp) + 1):
            for j in range(1, len(ref) + 1):
                d[i, j] = min(d[i - 1, j] + 1, d[i, j - 1] + 1,
                              d[i - 1, j - 1] + (hyp[i - 1] != ref[j - 1]))
        total_edits += int(d[-1, -1])
        total_len += len(ref)
    return total_edits / max(total_len, 1)


def train(lexicon_path: str, out_path: str, epochs: int = 120,
          batch_size: int = 64, lr: float = 2e-3, seed: int = 0,
          do_augment: bool = True, heldout_frac: float = 0.08,
          verbose: bool = True, device=None) -> dict:
    import torch

    from ..device import resolve_device

    device = resolve_device(device)
    pairs = load_pairs(lexicon_path)
    train_pairs, held_pairs = split_heldout(pairs, heldout_frac)
    if do_augment:
        n0 = len(train_pairs)
        train_pairs = augment(train_pairs)
        # drop augmented forms colliding with held-out words
        for w in held_pairs:
            train_pairs.pop(w, None)
        if verbose:
            print(f"augmented train lexicon {n0} -> {len(train_pairs)}")

    words = sorted(train_pairs)
    max_w = max(len(w) for w in words) + 2
    max_p = max(len(p) for p in train_pairs.values()) + 2

    rng = np.random.default_rng(seed)
    params = {k: torch.from_numpy(v).to(device).requires_grad_()
              for k, v in init_params(rng, len(G2IDX),
                                      len(PHONEMES)).items()}
    loss_fn = make_loss_fn()
    # optax.adam's defaults
    opt = torch.optim.Adam(params.values(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)

    n = len(words)
    # static batch count: pad the last batch by wrapping (epoch-level
    # shuffling makes the repeats uniform)
    order = np.arange(n)
    for epoch in range(epochs):
        rng.shuffle(order)
        losses = []
        for lo in range(0, n, batch_size):
            idx = order[lo:lo + batch_size]
            if len(idx) < batch_size:
                idx = np.concatenate([idx, order[:batch_size - len(idx)]])
            bw = [words[i] for i in idx]
            batch = [torch.from_numpy(a).to(device) for a in encode_batch(
                bw, [train_pairs[w] for w in bw], max_w, max_p)]
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, *batch)
            loss.backward()
            opt.step()
            losses.append(loss.detach())
        if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
            mean = float(np.mean(torch.stack(losses).cpu().numpy(),
                                 dtype=np.float64))
            print(f"epoch {epoch:3d}  loss {mean:.4f}")

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    np.savez_compressed(out_path, **{k: v.detach().cpu().numpy()
                                     for k, v in params.items()})

    model = g2p_model.G2PModel(out_path)
    per = phoneme_error_rate(model, held_pairs)
    per_stress = phoneme_error_rate(model, held_pairs, ignore_stress=False)
    report = {"held_out_words": len(held_pairs),
              "train_words": len(train_pairs),
              "per": round(per, 4), "per_with_stress": round(per_stress, 4)}
    if verbose:
        print(json.dumps(report))
    return report


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--lexicon", default=DEFAULT_SEED_LEXICON)
    parser.add_argument("--out", default=None,
                        help="weights file (default: the port's "
                             "text/data/g2p_weights.npz)")
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--no-augment", action="store_true")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default cuda)")
    args = parser.parse_args(argv)
    return train(args.lexicon, args.out or g2p_model.TRAINED_WEIGHTS,
                 epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                 seed=args.seed, do_augment=not args.no_augment,
                 device=args.device)


if __name__ == "__main__":
    main()
