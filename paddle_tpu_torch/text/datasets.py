"""Text dataset implementations. See package docstring for the offline
synthesis contract.

Reference formats honored when real files are present:
- Imdb: aclImdb tar.gz with {train,test}/{pos,neg}/*.txt
  (dataset/imdb.py)
- Imikolov: simple-examples tar.gz ptb.{train,valid}.txt
  (dataset/imikolov.py)
- WMT14/WMT16: token-id parallel corpora are synthesized only (the
  reference downloads preprocessed dicts; no egress here)
  (dataset/wmt14.py, wmt16.py)
- Conll05st: SRL tuples, synthesized (dataset/conll05.py)
- Movielens: ml-1m ratings triples (dataset/movielens.py)
- UCIHousing: 13-feature regression rows (dataset/uci_housing.py)
"""
from __future__ import annotations

import os
import tarfile

import numpy as np

from ..io import Dataset

from ..utils.data_home import DATA_HOME, warn_synthetic as _warn_synthetic

# shared deterministic word inventory for synthetic corpora
_POS_WORDS = ["good", "great", "excellent", "wonderful", "best", "love"]
_NEG_WORDS = ["bad", "awful", "terrible", "boring", "worst", "hate"]
_NEUTRAL = ["the", "a", "movie", "film", "plot", "actor", "scene", "story",
            "it", "was", "and", "of", "in", "to"]


class Imdb(Dataset):
    """IMDB sentiment (dataset/imdb.py): samples are (word-id sequence,
    label 0/1). ``word_idx`` maps token → id (0 reserved for OOV/pad)."""

    def __init__(self, data_file=None, mode="train", cutoff=150, seed=None):
        self.mode = mode
        self.synthetic = False
        data_file = data_file or os.path.join(DATA_HOME, "imdb",
                                              "aclImdb_v1.tar.gz")
        if os.path.exists(data_file):
            self._load_archive(data_file, mode, cutoff)
        else:
            self._synthesize(
                n=512 if mode == "train" else 128,
                seed=7 if mode == "train" else 8,
            )

    def _load_archive(self, path, mode, cutoff):
        import collections
        import re

        pat = re.compile(rf"aclImdb/{mode}/(pos|neg)/.*\.txt$")
        freq = collections.Counter()
        docs = []
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                g = pat.match(m.name)
                if not g:
                    continue
                words = tf.extractfile(m).read().decode(
                    "latin-1").lower().split()
                docs.append((words, 0 if g.group(1) == "neg" else 1))
                freq.update(words)
        vocab = [w for w, c in freq.most_common() if c >= cutoff]
        self.word_idx = {w: i + 1 for i, w in enumerate(vocab)}
        self.docs = [
            (np.asarray([self.word_idx.get(w, 0) for w in ws], np.int64), y)
            for ws, y in docs
        ]

    def _synthesize(self, n, seed):
        rng = np.random.RandomState(seed)
        vocab = _NEUTRAL + _POS_WORDS + _NEG_WORDS
        self.word_idx = {w: i + 1 for i, w in enumerate(vocab)}
        self.docs = []
        for k in range(n):
            y = int(rng.randint(0, 2))
            senti = _POS_WORDS if y else _NEG_WORDS
            length = int(rng.randint(8, 24))
            words = [
                (rng.choice(senti) if rng.rand() < 0.35
                 else rng.choice(_NEUTRAL))
                for _ in range(length)
            ]
            self.docs.append((
                np.asarray([self.word_idx[w] for w in words], np.int64), y,
            ))
        _warn_synthetic(self)
        self.synthetic = True

    @property
    def vocab_size(self):
        return len(self.word_idx) + 1

    def __getitem__(self, i):
        return self.docs[i]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """PTB n-gram LM dataset (dataset/imikolov.py): samples are n-tuples
    of word ids (first n-1 = context, last = target)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=2):
        self.synthetic = False
        self.window_size = int(window_size)
        data_file = data_file or os.path.join(
            DATA_HOME, "imikolov", "simple-examples.tgz"
        )
        split = "train" if mode == "train" else "valid"
        if os.path.exists(data_file):
            self._load_archive(data_file, split, min_word_freq)
        else:
            self._synthesize(
                n_sent=256 if mode == "train" else 64,
                seed=11 if mode == "train" else 12,
            )
        self._build(data_type)

    def _load_archive(self, path, split, min_freq):
        import collections

        with tarfile.open(path) as tf:
            name = f"./simple-examples/data/ptb.{split}.txt"
            for cand in (name, name[2:]):
                try:
                    raw = tf.extractfile(cand).read().decode()
                    break
                except KeyError:
                    continue
            else:
                raise FileNotFoundError(f"ptb.{split}.txt not in {path}")
        self.sents = [line.split() for line in raw.splitlines() if line]
        freq = collections.Counter(w for s in self.sents for w in s)
        vocab = sorted(w for w, c in freq.items() if c >= min_freq)
        self.word_idx = {w: i + 1 for i, w in enumerate(vocab)}

    def _synthesize(self, n_sent, seed):
        # markov-ish chains over a small vocab: n-gram prediction is
        # genuinely learnable (each word prefers a fixed successor)
        rng = np.random.RandomState(seed)
        vocab = _NEUTRAL + _POS_WORDS
        self.word_idx = {w: i + 1 for i, w in enumerate(vocab)}
        succ = {w: vocab[(i * 7 + 3) % len(vocab)]
                for i, w in enumerate(vocab)}
        self.sents = []
        for _ in range(n_sent):
            w = vocab[int(rng.randint(len(vocab)))]
            sent = [w]
            for _ in range(int(rng.randint(6, 14))):
                w = succ[w] if rng.rand() < 0.8 else vocab[
                    int(rng.randint(len(vocab)))]
                sent.append(w)
            self.sents.append(sent)
        _warn_synthetic(self)
        self.synthetic = True

    def _build(self, data_type):
        n = self.window_size
        self.samples = []
        for s in self.sents:
            ids = [self.word_idx.get(w, 0) for w in s]
            if data_type.upper() == "SEQ":
                self.samples.append(np.asarray(ids, np.int64))
                continue
            for k in range(len(ids) - n + 1):
                self.samples.append(np.asarray(ids[k:k + n], np.int64))

    @property
    def vocab_size(self):
        return len(self.word_idx) + 1

    def __getitem__(self, i):
        return self.samples[i]

    def __len__(self):
        return len(self.samples)


class _ParallelCorpus(Dataset):
    """Shared machinery for WMT14/WMT16: (src_ids, trg_in, trg_next)
    triples with <s>=1, <e>=2, OOV/pad=0 (dataset/wmt14.py id layout)."""

    BOS, EOS, PAD = 1, 2, 0

    def __init__(self, dict_size, mode, seed, n_train=384, n_test=96,
                 max_len=12):
        _warn_synthetic(self, fallback=False)
        self.synthetic = True
        self.dict_size = int(dict_size)
        rng = np.random.RandomState(seed + (0 if mode == "train" else 1))
        n = n_train if mode == "train" else n_test
        lo = 3  # ids below 3 are specials
        hi = max(lo + 1, self.dict_size)
        self.pairs = []
        for _ in range(n):
            length = int(rng.randint(3, max_len))
            src = rng.randint(lo, hi, length).astype(np.int64)
            trg = self._translate(src, hi, lo)
            trg_in = np.concatenate([[self.BOS], trg]).astype(np.int64)
            trg_next = np.concatenate([trg, [self.EOS]]).astype(np.int64)
            self.pairs.append((src, trg_in, trg_next))

    @staticmethod
    def _translate(src, hi, lo):
        # deterministic "language": reverse + fixed vocab permutation —
        # a seq2seq model can actually learn it (book-test requirement)
        return ((src[::-1] - lo) * 3 + 1) % (hi - lo) + lo

    def get_dict(self, reverse=False):
        d = {i: f"w{i}" for i in range(self.dict_size)}
        d[self.BOS], d[self.EOS], d[self.PAD] = "<s>", "<e>", "<unk>"
        if reverse:
            return {v: k for k, v in d.items()}
        return d

    def __getitem__(self, i):
        return self.pairs[i]

    def __len__(self):
        return len(self.pairs)

    def padded_arrays(self, max_len=None):
        """Batch the whole split into padded [N, L] arrays (book tests)."""
        L = max_len or max(len(s) for s, _, _ in self.pairs)
        Lt = (max_len or max(len(t) for _, t, _ in self.pairs))
        n = len(self.pairs)
        src = np.zeros((n, L), np.int64)
        tin = np.zeros((n, Lt), np.int64)
        tnx = np.zeros((n, Lt), np.int64)
        for i, (s, ti, tn) in enumerate(self.pairs):
            src[i, :min(L, len(s))] = s[:L]
            tin[i, :min(Lt, len(ti))] = ti[:Lt]
            tnx[i, :min(Lt, len(tn))] = tn[:Lt]
        return src, tin, tnx


class WMT14(_ParallelCorpus):
    """dataset/wmt14.py (dict_size-truncated en→fr)."""

    def __init__(self, data_file=None, mode="train", dict_size=64):
        super().__init__(dict_size, mode, seed=21)


class WMT16(_ParallelCorpus):
    """dataset/wmt16.py (BPE en↔de); same id layout, different seed."""

    def __init__(self, data_file=None, mode="train", src_dict_size=64,
                 trg_dict_size=64, lang="en"):
        super().__init__(max(src_dict_size, trg_dict_size), mode, seed=22)


class Conll05st(Dataset):
    """CoNLL-2005 SRL (dataset/conll05.py): samples are
    (word_ids, predicate_id, mark, label_ids) with BIO label space."""

    LABELS = ["O", "B-A0", "I-A0", "B-A1", "I-A1", "B-V"]

    def __init__(self, data_file=None, mode="train"):
        rng = np.random.RandomState(31 if mode == "train" else 32)
        _warn_synthetic(self)
        self.synthetic = True
        vocab = _NEUTRAL + _POS_WORDS + _NEG_WORDS
        self.word_idx = {w: i + 1 for i, w in enumerate(vocab)}
        self.label_idx = {l: i for i, l in enumerate(self.LABELS)}
        self.samples = []
        for _ in range(192 if mode == "train" else 48):
            length = int(rng.randint(5, 12))
            words = rng.randint(1, len(vocab) + 1, length).astype(np.int64)
            pred_pos = int(rng.randint(1, length - 1))
            mark = np.zeros(length, np.int64)
            mark[pred_pos] = 1
            labels = np.zeros(length, np.int64)  # O
            labels[pred_pos] = self.label_idx["B-V"]
            if pred_pos > 0:
                labels[0] = self.label_idx["B-A0"]
                labels[1:pred_pos] = self.label_idx["I-A0"]
            if pred_pos < length - 1:
                labels[pred_pos + 1] = self.label_idx["B-A1"]
                labels[pred_pos + 2:] = self.label_idx["I-A1"]
            self.samples.append((words, np.int64(words[pred_pos]), mark,
                                 labels))

    @property
    def vocab_size(self):
        return len(self.word_idx) + 1

    @property
    def num_labels(self):
        return len(self.LABELS)

    def __getitem__(self, i):
        return self.samples[i]

    def __len__(self):
        return len(self.samples)


class Movielens(Dataset):
    """MovieLens ratings (dataset/movielens.py): samples are
    (user_id, gender, age, occupation, movie_id, category, rating)."""

    NUM_USERS = 400
    NUM_MOVIES = 200
    NUM_CATEGORIES = 8
    NUM_OCCUPATIONS = 10

    def __init__(self, data_file=None, mode="train"):
        rng = np.random.RandomState(41 if mode == "train" else 42)
        _warn_synthetic(self)
        self.synthetic = True
        n = 2048 if mode == "train" else 512
        users = rng.randint(1, self.NUM_USERS + 1, n)
        movies = rng.randint(1, self.NUM_MOVIES + 1, n)
        # learnable signal: rating ~ affinity(user bucket, movie category)
        cat = movies % self.NUM_CATEGORIES
        affinity = (users % 5)[:, None] == (cat % 5)[:, None]
        rating = np.clip(
            3 + affinity[:, 0].astype(int) * 1.5
            + rng.randn(n) * 0.5, 1, 5,
        )
        self.samples = [
            (np.int64(u), np.int64(u % 2), np.int64(u % 7),
             np.int64(u % self.NUM_OCCUPATIONS), np.int64(m),
             np.int64(m % self.NUM_CATEGORIES), np.float32(r))
            for u, m, r in zip(users, movies, rating)
        ]

    def __getitem__(self, i):
        return self.samples[i]

    def __len__(self):
        return len(self.samples)


class UCIHousing(Dataset):
    """Boston housing regression (dataset/uci_housing.py): 13 features →
    price. Synthetic: price = linear(features) + noise."""

    FEATURE_DIM = 13

    def __init__(self, data_file=None, mode="train"):
        data_file = data_file or os.path.join(DATA_HOME, "uci_housing",
                                              "housing.data")
        self.synthetic = False
        if os.path.exists(data_file):
            raw = np.loadtxt(data_file).astype(np.float32)
            # normalize with FULL-corpus stats before the reference's
            # 404/102 split (uci_housing.py does the same: one
            # feature_range over all rows), so train/test share scaling
            feats_all = raw[:, :-1]
            mu = feats_all.mean(0)
            sd = feats_all.std(0) + 1e-6
            raw = raw[:404] if mode == "train" else raw[404:]
            feats = (raw[:, :-1] - mu) / sd
            self.features = feats
            self.prices = raw[:, -1].astype(np.float32)
            return
        else:
            rng = np.random.RandomState(51 if mode == "train" else 52)
            n = 404 if mode == "train" else 102
            feats = rng.randn(n, self.FEATURE_DIM).astype(np.float32)
            w = np.linspace(-1.0, 1.0, self.FEATURE_DIM).astype(np.float32)
            prices = feats @ w + 22.5 + rng.randn(n).astype(np.float32) * 0.5
            _warn_synthetic(self)
            self.synthetic = True
        # normalize like the reference loader (feature_range scaling)
        mu, sd = feats.mean(0), feats.std(0) + 1e-6
        self.features = (feats - mu) / sd
        self.prices = prices.astype(np.float32)

    def __getitem__(self, i):
        return self.features[i], np.asarray([self.prices[i]], np.float32)

    def __len__(self):
        return len(self.features)


class Sentiment(Dataset):
    """NLTK movie_reviews sentiment (dataset/sentiment.py): samples are
    (word-id sequence, label 0/1), vocabulary sorted by corpus frequency
    (sentiment.py:70 get_word_dict), interleaved neg/pos file order for
    cross reading (sentiment.py:91 sort_files), 1600/400 train/test
    split (NUM_TRAINING_INSTANCES).

    Real data: a movie_reviews directory (or zip layout extracted) with
    {pos,neg}/*.txt under ``data_file``. Otherwise loud synthetic.
    """

    NUM_TRAINING_INSTANCES = 1600
    NUM_TOTAL_INSTANCES = 2000

    def __init__(self, data_file=None, mode="train", seed=None):
        self.mode = mode
        self.synthetic = False
        self._seed = seed
        data_file = data_file or os.path.join(DATA_HOME, "corpora",
                                              "movie_reviews")
        if os.path.isdir(data_file):
            self._load_dir(data_file, mode)
        else:
            self._synthesize(mode)

    def _docs_to_ids(self, docs, labels, mode):
        import collections

        freq = collections.Counter()
        for words in docs:
            freq.update(words)
        # frequency-sorted vocabulary (ties broken by insertion order,
        # matching the reference's stable sort over iteritems)
        self.word_idx = {
            w: i for i, (w, _) in enumerate(
                sorted(freq.items(), key=lambda kv: -kv[1]))
        }
        data = [
            (np.asarray([self.word_idx[w] for w in words], np.int64), lab)
            for words, lab in zip(docs, labels)
        ]
        split = int(len(data) * self.NUM_TRAINING_INSTANCES
                    / self.NUM_TOTAL_INSTANCES)
        self.data = data[:split] if mode == "train" else data[split:]

    def _load_dir(self, root, mode):
        import glob as _glob

        neg = sorted(_glob.glob(os.path.join(root, "neg", "*.txt")))
        pos = sorted(_glob.glob(os.path.join(root, "pos", "*.txt")))
        if not neg or not pos or len(neg) != len(pos):
            raise ValueError(
                f"Sentiment: {root!r} exists but does not look like a "
                f"movie_reviews layout (found {len(neg)} neg / "
                f"{len(pos)} pos .txt files; need equal non-zero counts "
                "under neg/ and pos/)")
        docs, labels = [], []
        # interleave neg/pos (sort_files cross-reading order)
        for nf, pf in zip(neg, pos):
            for path, lab in ((nf, 0), (pf, 1)):
                with open(path, errors="ignore") as f:
                    docs.append(f.read().split())
                labels.append(lab)
        self._docs_to_ids(docs, labels, mode)

    def _synthesize(self, mode):
        _warn_synthetic(self)
        self.synthetic = True
        # seed=None keeps the historical fixed corpus (RandomState(31))
        rng = np.random.RandomState(31 if self._seed is None
                                    else self._seed)
        docs, labels = [], []
        for i in range(200):  # scaled-down corpus, same structure
            for lab, bank in ((0, _NEG_WORDS), (1, _POS_WORDS)):
                n = rng.randint(8, 24)
                words = [
                    (bank if rng.rand() < 0.4 else _NEUTRAL)[
                        rng.randint(0, 6)]
                    for _ in range(n)
                ]
                docs.append(words)
                labels.append(lab)
        self._docs_to_ids(docs, labels, mode)

    def get_word_dict(self):
        """[(word, rank)] sorted by frequency (sentiment.py:70)."""
        return sorted(self.word_idx.items(), key=lambda kv: kv[1])

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)


class MQ2007(Dataset):
    """LETOR MQ2007 learning-to-rank (dataset/mq2007.py).

    Parses the LETOR line format ``rel qid:<id> 1:<v> ... 46:<v> #docid
    = <d>`` into per-query groups and yields samples in one of the
    reference's formats (mq2007.py:295 __reader__):

    - "pointwise": (feature [46], score)
    - "pairwise":  (feature_left [46], feature_right [46]) with
      rel(left) > rel(right) (full partial order, mq2007.py:189)
    - "listwise":  (label_list [n], feature_list [n, 46])
    """

    FEATURE_DIM = 46

    def __init__(self, data_file=None, format="pairwise", mode="train",
                 fill_missing=-1.0):
        if format not in ("pointwise", "pairwise", "listwise"):
            raise ValueError(f"unknown MQ2007 format {format!r}")
        self.format = format
        self.synthetic = False
        data_file = data_file or os.path.join(
            DATA_HOME, "MQ2007", "Fold1",
            {"train": "train.txt", "test": "test.txt",
             "vali": "vali.txt"}[mode])
        if os.path.exists(data_file):
            queries = self._load_text(data_file, fill_missing)
        else:
            queries = self._synthesize(mode)
        self._build(queries)

    def _load_text(self, path, fill_missing):
        queries = {}
        with open(path) as f:
            for line in f:
                body = line.split("#")[0].split()
                if len(body) < 2:
                    continue
                rel = int(body[0])
                qid = int(body[1].split(":")[1])
                feat = np.full(self.FEATURE_DIM, fill_missing, np.float32)
                for tok in body[2:]:
                    k, v = tok.split(":")
                    feat[int(k) - 1] = float(v)
                queries.setdefault(qid, []).append((rel, feat))
        return queries

    def _synthesize(self, mode):
        _warn_synthetic(self)
        self.synthetic = True
        rng = np.random.RandomState(61 if mode == "train" else 62)
        queries = {}
        w = rng.randn(self.FEATURE_DIM).astype(np.float32)
        for qid in range(24):
            docs = []
            for _ in range(rng.randint(4, 12)):
                feat = rng.randn(self.FEATURE_DIM).astype(np.float32)
                # relevance correlates with a hidden linear score
                rel = int(np.clip(feat @ w / 4 + rng.randn() * 0.3 + 1,
                                  0, 2))
                docs.append((rel, feat))
            queries[qid] = docs
        return queries

    def _build(self, queries):
        self.data = []
        for qid in sorted(queries):
            docs = queries[qid]
            if self.format == "pointwise":
                for rel, feat in docs:
                    self.data.append((feat, np.float32(rel)))
            elif self.format == "pairwise":
                for i, (ri, fi) in enumerate(docs):
                    for rj, fj in docs[i + 1:]:
                        if ri > rj:
                            self.data.append((fi, fj))
                        elif rj > ri:
                            self.data.append((fj, fi))
            else:  # listwise
                labels = np.asarray([r for r, _ in docs], np.float32)
                feats = np.stack([f for _, f in docs])
                self.data.append((labels, feats))

    def __getitem__(self, i):
        return self.data[i]

    def __len__(self):
        return len(self.data)
