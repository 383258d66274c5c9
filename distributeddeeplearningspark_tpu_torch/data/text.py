"""Text pipeline — the port's copy of the MLM path of ``data/text.py``.

The JAX package's ``distributeddeeplearningspark_tpu/data/text.py``
tokenizes text partitions into fixed-shape MLM examples on the host; this
is its copy for the port, with the same arithmetic, so that the same
documents and seed give the same examples byte for byte:

``{"input_ids": [S] i32, "attention_mask": [S] i32,
   "mlm_labels": [S] i32, "mlm_weights": [S] f32}``

plus ``mlm_positions`` [P] (``max_predictions``, the gathered head's form)
and ``segment_ids`` [S] (packed-document ids) when asked for; and the
causal-LM feed of Llama's fine-tune (:func:`lm_dataset`),
``{"input_ids": [S] i32, "loss_mask": [S] f32}`` (+ ``segment_ids``).
Tokenizing, the per-document hot loop, can run over worker processes
(:mod:`.workers`); packing and masking stay on the consumer. Wikipedia
dumps, the HF tokenizer adapter and token statistics are not ported yet.
"""

from __future__ import annotations

import collections
import re
from typing import Iterable, Iterator, Sequence

import numpy as np

from distributeddeeplearningspark_tpu_torch.data import workers as workers_lib
from distributeddeeplearningspark_tpu_torch.rdd import PartitionedDataset

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)

_WORD_RE = re.compile(r"[a-z0-9]+|[^\sa-z0-9]")


class WordPieceTokenizer:
    """Greedy longest-match-first subword tokenizer (BERT's scheme)."""

    def __init__(self, vocab: dict[str, int]):
        self.vocab = dict(vocab)
        self.inv = {i: t for t, i in self.vocab.items()}
        for tok in SPECIAL_TOKENS:
            if tok not in self.vocab:
                raise ValueError(f"vocab missing special token {tok}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]
        self.mask_id = self.vocab[MASK]
        #: ids never selected for masking
        self.special_ids = frozenset(self.vocab[t] for t in SPECIAL_TOKENS)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def tokenize_word(self, word: str) -> list[int]:
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    cur = self.vocab[piece]
                    break
                end -= 1
            if cur is None:
                return [self.unk_id]
            ids.append(cur)
            start = end
        return ids

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for word in _WORD_RE.findall(text.lower()):
            ids.extend(self.tokenize_word(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        pieces = [self.inv.get(int(i), UNK) for i in ids]
        out: list[str] = []
        for p in pieces:
            if p.startswith("##") and out:
                out[-1] += p[2:]
            else:
                out.append(p)
        return " ".join(out)

    @staticmethod
    def train(corpus: Iterable[str], vocab_size: int = 8192, *, min_freq: int = 2
              ) -> "WordPieceTokenizer":
        """Frequency-based vocab: the specials, a char backstop (``c`` and
        ``##c`` for every character seen), then whole words by frequency."""
        counts: collections.Counter = collections.Counter()
        chars: set[str] = set()
        for line in corpus:
            for w in _WORD_RE.findall(line.lower()):
                counts[w] += 1
                chars.update(w)
        vocab: dict[str, int] = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
        for ch in sorted(chars):  # char backstop: no word is ever fully UNK
            for piece in (ch, "##" + ch):
                if piece not in vocab:
                    vocab[piece] = len(vocab)
        for w, c in counts.most_common():
            if len(vocab) >= vocab_size:
                break
            if c >= min_freq and w not in vocab:
                vocab[w] = len(vocab)
        return WordPieceTokenizer(vocab)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")

    @staticmethod
    def load(path: str) -> "WordPieceTokenizer":
        with open(path) as f:
            return WordPieceTokenizer({line.rstrip("\n"): i for i, line in enumerate(f)})


def _pack_token_windows(
    doc_tokens: Iterable[list[int]], window: int
) -> Iterator[tuple[list[int], list[int], bool]]:
    """Concatenate per-document token lists, tag every position with a
    running document counter, and cut ``window``-sized chunks →
    ``(chunk, seg_ids, is_partial)``; the corpus tail comes last, unpadded,
    with ``is_partial=True``."""
    buf: list[int] = []
    seg: list[int] = []
    doc_id = 0
    for toks in doc_tokens:
        buf.extend(toks)
        seg.extend([doc_id] * len(toks))
        doc_id += 1
        while len(buf) >= window:
            chunk, buf = buf[:window], buf[window:]
            cseg, seg = seg[:window], seg[window:]
            yield chunk, cseg, False
    if buf:
        yield buf, seg, True


def packed_segments_from_tokens(
    doc_tokens: Iterable, tokenizer: WordPieceTokenizer, seq_len: int
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Pack tokenized documents back-to-back into full ``[CLS] ... [SEP]``
    windows → (ids [S] i32, segment_ids [S] i32). Every window is full
    except the corpus tail, whose padding gets segment id -1; [CLS] joins
    the window's first document and the final [SEP] its last."""
    for chunk, cseg, partial in _pack_token_windows(doc_tokens, seq_len - 2):
        ids = [tokenizer.cls_id, *chunk, tokenizer.sep_id]
        sids = [cseg[0], *cseg, cseg[-1]]
        if partial:
            pad = seq_len - len(ids)
            ids += [tokenizer.pad_id] * pad
            sids += [-1] * pad
        yield np.array(ids, np.int32), np.array(sids, np.int32)


def _padded_from_tokens(
    doc_tokens: Iterable, tokenizer: WordPieceTokenizer, seq_len: int
) -> Iterator[np.ndarray]:
    """One document per ``[CLS] ... [SEP]`` window, padded to ``seq_len``
    (long documents split): the unpacked form of ``mlm_dataset(pack=False)``."""
    budget = seq_len - 2
    for toks in doc_tokens:
        toks = list(toks)
        if not toks:
            continue
        for off in range(0, len(toks), budget):
            chunk = toks[off:off + budget]
            ids = [tokenizer.cls_id, *chunk, tokenizer.sep_id]
            ids += [tokenizer.pad_id] * (seq_len - len(ids))
            yield np.array(ids, np.int32)


def _tokens_dataset(docs: PartitionedDataset, tok_fn, num_workers: int | None,
                    *, label: str) -> PartitionedDataset:
    """Per-document tokenize as a dataset stage: over worker processes when
    ``num_workers`` (or ``DLS_DATA_WORKERS``) asks for them, else the plain
    in-process ``map``; the same token stream either way."""
    if workers_lib.resolve_num_workers(num_workers) > 0:
        return workers_lib.WorkerMappedDataset(docs, tok_fn, num_workers,
                                               label=label)
    return docs.map(tok_fn)


def mask_tokens(
    ids: np.ndarray,
    tokenizer: WordPieceTokenizer,
    rng: np.random.Generator,
    *,
    mask_prob: float = 0.15,
) -> dict[str, np.ndarray]:
    """BERT's 80/10/10 MLM corruption → fixed-shape example dict."""
    ids = np.asarray(ids, np.int32)
    maskable = ~np.isin(ids, list(tokenizer.special_ids))
    sel = (rng.random(ids.shape) < mask_prob) & maskable
    if not sel.any() and maskable.any():  # guarantee ≥1 target per segment
        sel[rng.choice(np.flatnonzero(maskable))] = True

    corrupted = ids.copy()
    r = rng.random(ids.shape)
    corrupted[sel & (r < 0.8)] = tokenizer.mask_id
    rand_sel = sel & (r >= 0.8) & (r < 0.9)
    if rand_sel.any():
        # replacements come from the non-special ids
        candidates = np.setdiff1d(
            np.arange(tokenizer.vocab_size, dtype=np.int32),
            np.fromiter(tokenizer.special_ids, np.int32),
        )
        corrupted[rand_sel] = rng.choice(candidates, rand_sel.sum())
    # remaining 10%: keep original token

    return {
        "input_ids": corrupted,
        "attention_mask": (ids != tokenizer.pad_id).astype(np.int32),
        "mlm_labels": ids,
        "mlm_weights": sel.astype(np.float32),
    }


def pack_mlm_predictions(
    example: dict[str, np.ndarray], max_predictions: int
) -> dict[str, np.ndarray]:
    """Full-length MLM example → gathered form: ``mlm_positions`` [P] and
    ``mlm_labels``/``mlm_weights`` rewritten to [P] (zero-padded, weight 0),
    targets beyond P dropped, so the model's vocab projection runs on the
    masked positions only."""
    sel = np.flatnonzero(example["mlm_weights"] > 0)[:max_predictions]
    pos = np.zeros((max_predictions,), np.int32)
    labels = np.zeros((max_predictions,), np.int32)
    weights = np.zeros((max_predictions,), np.float32)
    pos[: len(sel)] = sel
    labels[: len(sel)] = example["mlm_labels"][sel]
    weights[: len(sel)] = example["mlm_weights"][sel]
    out = {
        "input_ids": example["input_ids"],
        "attention_mask": example["attention_mask"],
        "mlm_positions": pos,
        "mlm_labels": labels,
        "mlm_weights": weights,
    }
    if "segment_ids" in example:  # packed batches keep their doc boundaries
        out["segment_ids"] = example["segment_ids"]
    return out


def mlm_dataset(
    docs: PartitionedDataset,
    tokenizer: WordPieceTokenizer,
    *,
    seq_len: int = 128,
    mask_prob: float = 0.15,
    seed: int = 0,
    max_predictions: int | None = None,
    segment_ids: bool = False,
    pack: bool = True,
    num_workers: int | None = None,
) -> PartitionedDataset:
    """Text dataset → MLM example dataset (tokenize → pack → mask, per
    partition). Partition ``i`` masks with numpy's
    ``default_rng(seed * 100003 + i)``, as the JAX package does.

    ``max_predictions``: emit the gathered (``mlm_positions``) form.
    ``segment_ids``: also emit per-position document ids, so that attention
    is blocked across packed-document boundaries. ``pack=False``: one padded
    document per window. ``num_workers`` (default ``DLS_DATA_WORKERS``):
    tokenize across worker processes (:mod:`.workers`); the stateful
    window packing and the per-partition-seeded masking stay on the
    consumer, so the example stream is byte-identical at any count."""
    if not pack and segment_ids:
        raise ValueError(
            "segment_ids=True requires pack=True (padded mode has one "
            "document per window — there are no boundaries to mark)")

    token_ds = _tokens_dataset(
        docs, lambda doc: np.asarray(tokenizer.encode(doc), np.int32),
        num_workers, label="mlm_tokenize")

    def per_partition(pidx: int, toks: Iterable[np.ndarray]) -> Iterator[dict]:
        rng = np.random.default_rng(seed * 100003 + pidx)
        if not pack:
            gen: Iterator = (
                (ids, None)
                for ids in _padded_from_tokens(toks, tokenizer, seq_len))
        else:
            gen = packed_segments_from_tokens(toks, tokenizer, seq_len)
            if not segment_ids:
                gen = ((ids, None) for ids, _ in gen)
        for seg, sids in gen:
            ex = mask_tokens(seg, tokenizer, rng, mask_prob=mask_prob)
            if sids is not None:
                ex["segment_ids"] = sids
            yield (pack_mlm_predictions(ex, max_predictions)
                   if max_predictions else ex)

    return token_ds.map_partitions_with_index(per_partition)


def lm_dataset(
    docs: PartitionedDataset,
    tokenizer: WordPieceTokenizer,
    *,
    seq_len: int = 512,
    eos_between_docs: bool = True,
    segment_ids: bool = False,
    num_workers: int | None = None,
) -> PartitionedDataset:
    """Text dataset → packed causal-LM blocks (config 5's fine-tune feed),
    the same bytes as the JAX package's.

    Documents are tokenized and concatenated (SEP between documents), then
    cut into ``seq_len`` windows: ``{"input_ids": [S] i32, "loss_mask": [S]
    f32}``; ``loss_mask`` zeroes the padding of the corpus's short last
    block, and a last block of one token is dropped (it has no target).
    ``segment_ids=True`` adds per-position document ids (a running
    counter; the SEP belongs to the document it ends; pads get -1), so
    attention is blocked across packed documents. ``num_workers``: tokenize
    across worker processes; packing stays on the consumer, so the stream
    is the same at any count."""
    token_ds = _tokens_dataset(
        docs,
        lambda doc: np.asarray(
            tokenizer.encode(doc)
            + ([tokenizer.sep_id] if eos_between_docs else []), np.int32),
        num_workers, label="lm_tokenize")

    def per_partition(pidx: int, stream: Iterable[np.ndarray]) -> Iterator[dict]:
        del pidx
        for chunk, cseg, partial in _pack_token_windows(stream, seq_len):
            if partial and len(chunk) <= 1:
                continue  # a lone token has no next-token target
            mask = np.zeros(seq_len, np.float32)
            mask[: len(chunk)] = 1.0
            ids = chunk + [tokenizer.pad_id] * (seq_len - len(chunk))
            ex = {"input_ids": np.array(ids, np.int32),
                  "loss_mask": (np.ones(seq_len, np.float32)
                                if not partial else mask)}
            if segment_ids:
                sids = cseg + [-1] * (seq_len - len(cseg))
                ex["segment_ids"] = np.array(sids, np.int32)
            yield ex

    return token_ds.map_partitions_with_index(per_partition)


def synthetic_wikipedia(
    num_docs: int = 512, *, num_partitions: int = 4, seed: int = 0
) -> PartitionedDataset:
    """Markov-chain pseudo-prose: learnable bigram structure over a small
    word list, the same documents as the JAX package's for the same
    arguments."""
    base = [
        "the", "of", "and", "in", "to", "was", "is", "for", "as", "on", "by",
        "with", "city", "river", "history", "population", "century", "state",
        "university", "world", "war", "government", "species", "music", "film",
        "science", "theory", "system", "language", "island", "mountain",
    ]

    def make_partition(pidx: int):
        def gen() -> Iterator[str]:
            rng = np.random.default_rng(seed * 1000 + pidx)
            n = num_docs // num_partitions
            # fixed bigram table (shared across partitions: same "language")
            trng = np.random.default_rng(20260729)
            nxt = {w: trng.choice(base, 4, replace=True) for w in base}
            for _ in range(n):
                w = base[int(rng.integers(len(base)))]
                words = [w]
                for _ in range(int(rng.integers(60, 120))):
                    w = nxt[w][int(rng.integers(4))]
                    words.append(w)
                yield " ".join(words)

        return gen

    return PartitionedDataset([make_partition(i) for i in range(num_partitions)])
