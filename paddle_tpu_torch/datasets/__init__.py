"""Built-in datasets.

Counterpart of ``paddle_tpu.datasets``: the same fifteen datasets,
``DATA_HOME`` and ``_require``, reading the standard archive formats from
the same local cache (``DATA_HOME``, default
``~/.cache/paddle_tpu/datasets``, override with env ``PT_DATA_HOME``) and
never the network. A missing file raises with the exact path and the
official source URL so the operator can stage it. Every dataset also
offers ``mode="synthetic"``, a small deterministic stand-in with the real
shapes and dtypes drawn from the same numpy seeds as the JAX package's,
so both packages give equal arrays. Items are numpy arrays, as there; a
``DataLoader`` moves them to the device. ``Imikolov`` builds its
vocabulary through the native :class:`~paddle_tpu_torch.native.Tokenizer`
(through its Python path when the text holds Unicode whitespace).
"""

from __future__ import annotations

import gzip
import io
import os
import pickle
import struct
import tarfile
from typing import Callable, Optional, Sequence

import numpy as np

from ..data import Dataset

__all__ = ["DATA_HOME", "MNIST", "FashionMNIST", "Cifar10", "Cifar100",
           "UCIHousing", "Imdb", "Imikolov", "Movielens", "WMT14",
           "WMT16", "MQ2007", "Conll05", "Flowers", "VOC2012",
           "MovieReviews"]


def DATA_HOME() -> str:
    return os.environ.get(
        "PT_DATA_HOME",
        os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu",
                     "datasets"))


def _require(path: str, url_hint: str) -> str:
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file not found: {path}\n"
            f"This framework does not download (zero-egress by design; "
            f"ref capability: paddle.dataset download cache). Stage the "
            f"file there manually, e.g. from {url_hint}, or use "
            f"mode='synthetic'.")
    return path


class _ArrayDataset(Dataset):
    """images/labels pair with an optional per-sample transform."""

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 transform: Optional[Callable] = None) -> None:
        self.images = images
        self.labels = labels
        self.transform = transform

    def __getitem__(self, idx: int):
        img = self.images[idx]
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[idx]

    def __len__(self) -> int:
        return len(self.images)


def _parse_idx_images(path: str) -> np.ndarray:
    """MNIST idx3 format (ref: dataset/mnist.py reader_creator parses the
    same magic/count/rows/cols header)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"{path}: bad idx3 magic {magic}")
        data = np.frombuffer(f.read(n * rows * cols), np.uint8)
    return data.reshape(n, 1, rows, cols)


def _parse_idx_labels(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"{path}: bad idx1 magic {magic}")
        return np.frombuffer(f.read(n), np.uint8).astype(np.int64)


class MNIST(_ArrayDataset):
    """(ref: dataset/mnist.py, hapi/datasets/mnist.py).

    Expects ``{DATA_HOME}/mnist/{train,t10k}-images-idx3-ubyte.gz`` (+
    labels). Images are float32 in [0, 1], shape [1, 28, 28].
    """

    _URL = "http://yann.lecun.com/exdb/mnist/"
    _NAME = "mnist"

    def __init__(self, mode: str = "train",
                 transform: Optional[Callable] = None,
                 data_home: Optional[str] = None) -> None:
        if mode == "synthetic":
            rng = np.random.default_rng(42)
            labels = np.arange(256) % 10
            means = rng.normal(0.3, 0.15, (10, 1, 28, 28))
            images = np.clip(
                means[labels] + rng.normal(0, 0.05, (256, 1, 28, 28)),
                0, 1).astype(np.float32)
            super().__init__(images, labels.astype(np.int64), transform)
            return
        prefix = {"train": "train", "test": "t10k"}[mode]
        home = data_home or os.path.join(DATA_HOME(), self._NAME)
        imgs = labs = None
        for ext in (".gz", ""):
            p = os.path.join(home, f"{prefix}-images-idx3-ubyte{ext}")
            if os.path.exists(p):
                imgs = _parse_idx_images(p)
                labs = _parse_idx_labels(os.path.join(
                    home, f"{prefix}-labels-idx1-ubyte{ext}"))
                break
        if imgs is None:
            _require(os.path.join(
                home, f"{prefix}-images-idx3-ubyte.gz"), self._URL)
        images = (imgs.astype(np.float32) / 255.0)
        super().__init__(images, labs, transform)


class FashionMNIST(MNIST):
    """Same idx format, different archive directory (ref:
    hapi/datasets/mnist.py FashionMNIST)."""

    _URL = "http://fashion-mnist.s3-website.eu-central-1.amazonaws.com/"
    _NAME = "fashion-mnist"


def _load_cifar_archive(path: str, n_classes: int, want_test: bool):
    """CIFAR python-pickle batches inside tar.gz (ref: dataset/cifar.py
    reader_creator: same 'data'/'labels'/'fine_labels' keys; cifar-10
    ships data_batch_1..5 + test_batch, cifar-100 ships train + test)."""
    images, labels = [], []
    key = "labels" if n_classes == 10 else "fine_labels"
    with tarfile.open(path, "r:*") as tar:
        for member in sorted(tar.getnames()):
            base = os.path.basename(member)
            is_train = base.startswith("data_batch") or base == "train"
            is_test = base in ("test_batch", "test")
            if want_test != is_test or not (is_train or is_test):
                continue
            f = tar.extractfile(member)
            if f is None:
                continue
            batch = pickle.loads(f.read(), encoding="latin1")
            images.append(np.asarray(batch["data"], np.uint8))
            labels.extend(batch[key])
    return images, labels


class Cifar10(_ArrayDataset):
    """(ref: dataset/cifar.py). Expects
    ``{DATA_HOME}/cifar/cifar-10-python.tar.gz``. Images float32 [0,1],
    shape [3, 32, 32]."""

    _URL = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
    _N = 10

    def __init__(self, mode: str = "train",
                 transform: Optional[Callable] = None,
                 data_home: Optional[str] = None) -> None:
        if mode == "synthetic":
            rng = np.random.default_rng(7)
            labels = np.arange(128) % self._N
            means = rng.normal(0.45, 0.2, (self._N, 3, 32, 32))
            images = np.clip(
                means[labels % self._N]
                + rng.normal(0, 0.08, (128, 3, 32, 32)),
                0, 1).astype(np.float32)
            super().__init__(images, labels.astype(np.int64), transform)
            return
        home = data_home or os.path.join(DATA_HOME(), "cifar")
        path = _require(os.path.join(
            home, os.path.basename(self._URL)), self._URL)
        batches, labs = _load_cifar_archive(path, self._N,
                                            want_test=mode == "test")
        data = np.concatenate(batches).reshape(-1, 3, 32, 32)
        super().__init__(data.astype(np.float32) / 255.0,
                         np.asarray(labs, np.int64), transform)


class Cifar100(Cifar10):
    _URL = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"
    _N = 100


class UCIHousing(Dataset):
    """(ref: dataset/uci_housing.py — 13 features, normalized, 80/20
    train/test split by the same UCI_TRAIN_DATA ratio)."""

    _URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
            "housing/housing.data")

    def __init__(self, mode: str = "train",
                 data_home: Optional[str] = None) -> None:
        if mode == "synthetic":
            rng = np.random.default_rng(3)
            x = rng.normal(0, 1, (100, 13)).astype(np.float32)
            w = rng.normal(0, 1, (13,)).astype(np.float32)
            y = (x @ w + rng.normal(0, 0.1, (100,))).astype(np.float32)
            self.x, self.y = x, y[:, None]
            return
        home = data_home or os.path.join(DATA_HOME(), "uci_housing")
        path = _require(os.path.join(home, "housing.data"), self._URL)
        raw = np.loadtxt(path, dtype=np.float32)
        feats, target = raw[:, :-1], raw[:, -1:]
        # normalize per feature (ref: feature_range maximums/minimums)
        mins, maxs = feats.min(0), feats.max(0)
        feats = (feats - mins) / np.maximum(maxs - mins, 1e-12)
        split = int(len(feats) * 0.8)
        if mode == "train":
            self.x, self.y = feats[:split], target[:split]
        else:
            self.x, self.y = feats[split:], target[split:]

    def __getitem__(self, idx: int):
        return self.x[idx], self.y[idx]

    def __len__(self) -> int:
        return len(self.x)


class Imdb(Dataset):
    """IMDB sentiment (ref: dataset/imdb.py — parses aclImdb_v1.tar.gz,
    builds a frequency-sorted word dict, yields (token_ids, 0/1)).

    Sequences are padded/truncated to ``seq_len`` with 0 (the reference
    yields ragged LoD sequences; dense padded is this package's layout,
    SURVEY §7 'LoD/ragged' decision).
    """

    _URL = ("https://ai.stanford.edu/~amaas/data/sentiment/"
            "aclImdb_v1.tar.gz")

    def __init__(self, mode: str = "train", cutoff: int = 150,
                 seq_len: int = 256,
                 data_home: Optional[str] = None) -> None:
        self.seq_len = seq_len
        if mode == "synthetic":
            rng = np.random.default_rng(11)
            n, vocab = 128, 512
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            self.docs = rng.integers(
                2, vocab, (n, seq_len)).astype(np.int64)
            self.labels = (np.arange(n) % 2).astype(np.int64)
            # class signal: positive docs lean on low ids
            self.docs[self.labels == 1] //= 2
            return
        import re
        home = data_home or os.path.join(DATA_HOME(), "imdb")
        path = _require(os.path.join(home, "aclImdb_v1.tar.gz"),
                        self._URL)
        sub = "train" if mode == "train" else "test"
        pat_pos = re.compile(rf"aclImdb/{sub}/pos/.*\.txt$")
        pat_neg = re.compile(rf"aclImdb/{sub}/neg/.*\.txt$")
        # vocab over train AND test (ref: imdb.py build_dict walks both
        # patterns) — a per-split vocab would permute token ids between
        # the splits and silently break evaluation
        pat_vocab = re.compile(r"aclImdb/(train|test)/(pos|neg)/.*\.txt$")
        tok = re.compile(r"[a-z]+")
        docs_words, labels = [], []
        freq: dict = {}
        with tarfile.open(path, "r:*") as tar:
            for member in tar.getmembers():
                if not pat_vocab.match(member.name):
                    continue
                f = tar.extractfile(member)
                words = tok.findall(
                    f.read().decode("utf-8", "ignore").lower())
                for w in words:
                    freq[w] = freq.get(w, 0) + 1
                lab = 1 if pat_pos.match(member.name) else \
                    0 if pat_neg.match(member.name) else None
                if lab is not None:
                    docs_words.append(words)
                    labels.append(lab)
        # frequency-sorted dict, ids from 2 (0=pad, 1=OOV) — ref
        # build_dict sorts by (-count, word)
        vocab = sorted((w for w, c in freq.items() if c >= cutoff),
                       key=lambda w: (-freq[w], w))
        self.word_idx = {w: i + 2 for i, w in enumerate(vocab)}
        docs = np.zeros((len(docs_words), seq_len), np.int64)
        for i, words in enumerate(docs_words):
            ids = [self.word_idx.get(w, 1) for w in words[:seq_len]]
            docs[i, :len(ids)] = ids
        self.docs = docs
        self.labels = np.asarray(labels, np.int64)

    def __getitem__(self, idx: int):
        return self.docs[idx], self.labels[idx]

    def __len__(self) -> int:
        return len(self.docs)


class Imikolov(Dataset):
    """PTB language-model dataset (ref: dataset/imikolov.py — parses
    simple-examples.tgz, frequency-sorted dict with <s>/<e>/<unk>,
    yields n-grams or full sequences).

    ``data_type="ngram"`` yields (context [n-1], next_word);
    ``data_type="seq"`` yields (padded sequence [seq_len], length) —
    padding uses a DEDICATED ``pad_id`` (one past <unk>), never a real
    word id, and the true length rides along so losses can mask.
    """

    _URL = "http://www.fit.vutbr.cz/~imikolov/rnnlm/simple-examples.tgz"

    def __init__(self, mode: str = "train", data_type: str = "ngram",
                 window_size: int = 5, seq_len: int = 64,
                 min_word_freq: int = 50,
                 data_home: Optional[str] = None,
                 use_native_tokenizer: bool = False) -> None:
        self.data_type = data_type
        self.window_size = window_size
        self.use_native_tokenizer = use_native_tokenizer
        if mode == "synthetic":
            rng = np.random.default_rng(13)
            vocab = 200
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            if data_type == "ngram":
                n = 512
                self.ctx = rng.integers(0, vocab, (n, window_size - 1)) \
                    .astype(np.int64)
                self.nxt = (self.ctx.sum(1) % vocab).astype(np.int64)
            else:
                n = 64
                self.pad_id = vocab
                self.seqs = rng.integers(0, vocab, (n, seq_len)) \
                    .astype(np.int64)
                self.seq_lens = np.full((n,), seq_len, np.int64)
            return
        home = data_home or os.path.join(DATA_HOME(), "imikolov")
        path = _require(os.path.join(home, "simple-examples.tgz"),
                        self._URL)
        fname = ("./simple-examples/data/ptb.train.txt" if mode == "train"
                 else "./simple-examples/data/ptb.valid.txt")
        with tarfile.open(path, "r:*") as tar:
            # dict over the TRAIN split only (ref: build_dict(train()))
            f = tar.extractfile("./simple-examples/data/ptb.train.txt")
            train_text = f.read().decode("utf-8")
            train_lines = train_text.splitlines()
            if mode == "train":
                lines_cache = train_lines
            else:
                f = tar.extractfile(fname)
                lines_cache = f.read().decode("utf-8").splitlines()
        # The C++ tokenizer splits on ASCII whitespace (istream >>);
        # Python str.split() also splits on Unicode whitespace. PTB is
        # ASCII, but a user-staged corpus may not be — fall back to the
        # Python path rather than silently diverge.
        _uni_ws = "\u00a0\u1680\u2000\u2028\u2029\u202f\u205f\u3000\u0085"
        if use_native_tokenizer and any(c in train_text for c in _uni_ws):
            use_native_tokenizer = False
        if use_native_tokenizer:
            # threaded C++ counting (csrc/tokenizer.cc) — same
            # frequency-ranked ordering as the Python path below, so the
            # resulting word ids are identical (tested)
            import os as _os
            import tempfile

            from ..native import Tokenizer
            with tempfile.NamedTemporaryFile("w", suffix=".txt",
                                             encoding="utf-8",
                                             delete=False) as tf:
                tf.write(train_text)
                tmp_corpus = tf.name
            try:
                with Tokenizer.build([tmp_corpus], min_freq=1) as tok:
                    # counts come straight from the build (one C call);
                    # words via the saved vocab file (one I/O) instead
                    # of a per-word ctypes round-trip
                    cnts = tok.freqs()
                    vpath = tmp_corpus + ".vocab"
                    tok.save(vpath)
                    with open(vpath, encoding="utf-8") as vf:
                        vocab_words = vf.read().splitlines()
                    _os.unlink(vpath)
            finally:
                _os.unlink(tmp_corpus)
            freq = {w: int(c) for w, c in zip(vocab_words, cnts)
                    if c > min_word_freq and w != "<unk>"}
        else:
            freq = {}
            for line in train_lines:
                for w in line.strip().split():
                    freq[w] = freq.get(w, 0) + 1
            freq = {w: c for w, c in freq.items() if c > min_word_freq
                    and w != "<unk>"}
        words = sorted(freq.items(), key=lambda kv: (-kv[1], kv[0]))
        # ids: 0.. for frequency-sorted corpus words, then <s>/<e>/<unk>
        # appended. NOTE: internally consistent but NOT identical to the
        # reference's build_dict ids (imikolov.py counts <s>/<e> once
        # per line so they land frequency-ranked, and builds over
        # train+valid); re-encode rather than mixing with
        # reference-derived id artifacts.
        self.word_idx = {w: i for i, (w, _) in enumerate(words)}
        self.word_idx["<s>"] = len(self.word_idx)
        self.word_idx["<e>"] = len(self.word_idx)
        unk = self.word_idx["<unk>"] = len(self.word_idx)
        bos, eos = self.word_idx["<s>"], self.word_idx["<e>"]
        if data_type == "ngram":
            ctxs, nxts = [], []
            n = window_size
            for line in lines_cache:
                ids = [bos] + [self.word_idx.get(w, unk)
                               for w in line.strip().split()] + [eos]
                for i in range(n - 1, len(ids)):
                    ctxs.append(ids[i - n + 1: i])
                    nxts.append(ids[i])
            self.ctx = np.asarray(ctxs, np.int64)
            self.nxt = np.asarray(nxts, np.int64)
        else:
            self.pad_id = len(self.word_idx)  # one past <unk>
            seqs, lens = [], []
            for line in lines_cache:
                ids = [bos] + [self.word_idx.get(w, unk)
                               for w in line.strip().split()] + [eos]
                row = np.full((seq_len,), self.pad_id, np.int64)
                n_ids = min(len(ids), seq_len)
                row[:n_ids] = ids[:seq_len]
                seqs.append(row)
                lens.append(n_ids)
            self.seqs = np.stack(seqs)
            self.seq_lens = np.asarray(lens, np.int64)

    def __len__(self):
        return len(self.ctx) if self.data_type == "ngram" \
            else len(self.seqs)

    def __getitem__(self, i):
        if self.data_type == "ngram":
            return self.ctx[i], self.nxt[i]
        return self.seqs[i], self.seq_lens[i]


class Movielens(Dataset):
    """MovieLens 1-M ratings (ref: dataset/movielens.py — parses
    ml-1m.zip's ::-separated users.dat/movies.dat/ratings.dat; yields
    (user_id, gender, age_bucket, job, movie_id, first_category,
    rating)).

    Dense int features sized for the framework's RecommenderSystem
    model; ``holdout`` fraction becomes the test split (the reference
    random-splits 9:1 per user).
    """

    _URL = "http://files.grouplens.org/datasets/movielens/ml-1m.zip"
    AGE_TABLE = (1, 18, 25, 35, 45, 50, 56)

    def __init__(self, mode: str = "train", holdout: float = 0.1,
                 data_home: Optional[str] = None) -> None:
        if mode == "synthetic":
            rng = np.random.default_rng(17)
            n = 256
            self.rows = np.stack([
                rng.integers(1, 100, n), rng.integers(0, 2, n),
                rng.integers(0, 7, n), rng.integers(0, 21, n),
                rng.integers(1, 120, n), rng.integers(0, 19, n),
            ], 1).astype(np.int64)
            self.ratings = rng.integers(1, 6, (n, 1)).astype(np.float32)
            self.categories = [f"c{i}" for i in range(19)]
            return
        import io
        import zipfile
        home = data_home or os.path.join(DATA_HOME(), "movielens")
        path = _require(os.path.join(home, "ml-1m.zip"), self._URL)
        users, movies = {}, {}
        cats: dict = {}
        with zipfile.ZipFile(path) as z:
            with z.open("ml-1m/users.dat") as f:
                for line in io.TextIOWrapper(f, "latin-1"):
                    uid, gender, age, job, _zip = line.strip().split("::")
                    users[int(uid)] = (
                        0 if gender == "M" else 1,
                        self.AGE_TABLE.index(int(age)), int(job))
            with z.open("ml-1m/movies.dat") as f:
                for line in io.TextIOWrapper(f, "latin-1"):
                    mid, _title, genres = line.strip().split("::")
                    g0 = genres.split("|")[0]
                    cats.setdefault(g0, len(cats))
                    movies[int(mid)] = cats[g0]
            rows, ratings = [], []
            with z.open("ml-1m/ratings.dat") as f:
                for line in io.TextIOWrapper(f, "latin-1"):
                    uid, mid, rate, _ts = line.strip().split("::")
                    uid, mid = int(uid), int(mid)
                    if uid not in users or mid not in movies:
                        continue
                    g, a, j = users[uid]
                    rows.append((uid, g, a, j, mid, movies[mid]))
                    ratings.append(float(rate))
        rows_np = np.asarray(rows, np.int64)
        ratings_np = np.asarray(ratings, np.float32)[:, None]
        # deterministic split (ref uses a seeded random 9:1)
        rng = np.random.default_rng(0)
        take_test = rng.random(len(rows_np)) < holdout
        pick = take_test if mode == "test" else ~take_test
        self.rows = rows_np[pick]
        self.ratings = ratings_np[pick]
        self.categories = sorted(cats, key=cats.get)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i], self.ratings[i]


class WMT16(Dataset):
    """Multi30K EN-DE translation pairs (ref: dataset/wmt16.py — parses
    wmt16.tar.gz's tab-separated "en<TAB>de" train/val/test members,
    builds frequency-sorted dicts per language with <s>/<e>/<unk> at ids
    0/1/2, yields (src_ids, trg_ids, trg_ids_next)).

    Dense padded redesign: sequences pad to ``seq_len`` with <e> after
    the end mark; per-row lengths ride along so losses can mask. The
    (trg_ids, trg_ids_next) teacher-forcing pair follows the reference
    exactly: trg = <s> + words, trg_next = words + <e>.
    """

    _URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt16.tar.gz"
    START, END, UNK = 0, 1, 2

    def __init__(self, mode: str = "train", src_dict_size: int = 4000,
                 trg_dict_size: int = 4000, src_lang: str = "en",
                 seq_len: int = 50,
                 data_home: Optional[str] = None) -> None:
        self.seq_len = seq_len
        if mode == "synthetic":
            rng = np.random.default_rng(19)
            n, v = 128, 200
            self.src_dict = {f"w{i}": i for i in range(v)}
            self.trg_dict = dict(self.src_dict)
            self.src = rng.integers(3, v, (n, seq_len)).astype(np.int64)
            self.trg = np.roll(self.src, 1, axis=1)
            self.trg[:, 0] = self.START
            self.trg_next = self.src.copy()
            self.src_len = np.full((n,), seq_len, np.int64)
            self.trg_len = np.full((n,), seq_len, np.int64)
            return
        home = data_home or os.path.join(DATA_HOME(), "wmt16")
        path = _require(os.path.join(home, "wmt16.tar.gz"), self._URL)
        member = {"train": "wmt16/train", "val": "wmt16/val",
                  "test": "wmt16/test"}[mode]
        src_col = 0 if src_lang == "en" else 1

        # ONE pass over the gzip'd train member counts both language
        # columns (dicts always come from train, whatever the mode);
        # the decoded lines are cached so mode="train" never re-streams
        # the archive
        self._line_cache = {}
        freqs = ({}, {})
        for raw in self._member_lines(path, "wmt16/train"):
            parts = raw.strip().split("\t")
            if len(parts) != 2:
                continue
            for col in (0, 1):
                for w in parts[col].split():
                    freqs[col][w] = freqs[col].get(w, 0) + 1

        def build_dict(col, size):
            # ref ordering: specials then frequency-sorted, cut to size.
            # Corpus tokens spelled like the specials are skipped — a
            # literal "<unk>" would otherwise clobber id 2 (same filter
            # Imikolov applies).
            d = {"<s>": 0, "<e>": 1, "<unk>": 2}
            for w, _ in sorted(freqs[col].items(), key=lambda kv: -kv[1]):
                if len(d) >= size:
                    break
                if w not in d:
                    d[w] = len(d)
            return d

        self.src_dict = build_dict(src_col, src_dict_size)
        self.trg_dict = build_dict(1 - src_col, trg_dict_size)
        src_rows, trg_rows, trg_next_rows = [], [], []
        src_lens, trg_lens = [], []

        def pad(ids):
            row = np.full((seq_len,), self.END, np.int64)
            n_ids = min(len(ids), seq_len)
            row[:n_ids] = ids[:seq_len]
            return row, n_ids

        for raw in self._member_lines(path, member):
                parts = raw.strip().split("\t")
                if len(parts) != 2:
                    continue
                # truncate WORDS first so <s>/<e> always survive — the
                # padded row's invariant (row[len-1] == <e>) is what
                # decode-until-<e> consumers key on
                sw = parts[src_col].split()[: seq_len - 2]
                tw = parts[1 - src_col].split()[: seq_len - 2]
                src_ids = [self.START] + [
                    self.src_dict.get(w, self.UNK) for w in sw] \
                    + [self.END]
                t_ids = [self.trg_dict.get(w, self.UNK) for w in tw]
                trg_ids = [self.START] + t_ids
                trg_next = t_ids + [self.END]
                s_row, s_len = pad(src_ids)
                t_row, t_len = pad(trg_ids)
                tn_row, _ = pad(trg_next)
                src_rows.append(s_row)
                trg_rows.append(t_row)
                trg_next_rows.append(tn_row)
                src_lens.append(s_len)
                trg_lens.append(t_len)
        self.src = np.stack(src_rows)
        self.trg = np.stack(trg_rows)
        self.trg_next = np.stack(trg_next_rows)
        self.src_len = np.asarray(src_lens, np.int64)
        self.trg_len = np.asarray(trg_lens, np.int64)

    def _member_lines(self, path, member):
        if member not in self._line_cache:
            with tarfile.open(path, "r:*") as tar:
                text = tar.extractfile(member).read().decode("utf-8")
            self._line_cache[member] = text.splitlines()
        return self._line_cache[member]

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i):
        return (self.src[i], self.trg[i], self.trg_next[i],
                self.src_len[i], self.trg_len[i])


class WMT14(Dataset):
    """WMT14 EN-FR shrunk set (ref: dataset/wmt14.py:117 — the archive
    ships PRE-BUILT ``src.dict``/``trg.dict`` members whose word id is
    the line number (cut to ``dict_size``), plus tab-separated
    "src<TAB>trg" data members; unlike wmt16 no dict is built from the
    corpus). Reference semantics kept: <s>/<e>/<unk> at ids 0/1/2
    (UNK_IDX=2), sequences longer than 80 tokens are dropped,
    src = <s> + words + <e>, and the teacher-forcing pair is
    trg = <s> + words / trg_next = words + <e>.

    Dense padded redesign like WMT16: rows pad to ``seq_len`` with <e>
    and per-row lengths ride along so losses can mask.
    """

    _URL = "http://paddlemodels.bj.bcebos.com/wmt/wmt14.tgz"
    START, END, UNK = 0, 1, 2
    _MAX_LEN = 80  # ref wmt14.py: "remove sequence whose length > 80"

    def __init__(self, mode: str = "train", dict_size: int = 30000,
                 seq_len: int = 50,
                 data_home: Optional[str] = None) -> None:
        self.seq_len = seq_len
        if mode == "synthetic":
            rng = np.random.default_rng(29)
            n, v = 128, 200
            self.src_dict = {f"w{i}": i for i in range(v)}
            self.trg_dict = dict(self.src_dict)
            self.src = rng.integers(3, v, (n, seq_len)).astype(np.int64)
            self.trg = np.roll(self.src, 1, axis=1)
            self.trg[:, 0] = self.START
            self.trg_next = self.src.copy()
            self.src_len = np.full((n,), seq_len, np.int64)
            self.trg_len = np.full((n,), seq_len, np.int64)
            return
        home = data_home or os.path.join(DATA_HOME(), "wmt14")
        path = _require(os.path.join(home, "wmt14.tgz"), self._URL)
        member_suffix = {"train": "train/train", "test": "test/test",
                         "gen": "gen/gen"}[mode]

        def to_dict(lines):
            # ref __read_to_dict: id = line number, cut to dict_size
            return {ln.strip(): i for i, ln in enumerate(lines)
                    if i < dict_size}

        with tarfile.open(path, "r:*") as tar:
            names = tar.getnames()

            def one(suffix):
                hits = [n for n in names if n.endswith(suffix)]
                if len(hits) != 1:
                    raise ValueError(
                        f"wmt14 archive: expected exactly one member "
                        f"ending in {suffix!r}, found {hits}")
                return tar.extractfile(hits[0]).read().decode(
                    "utf-8").splitlines()

            self.src_dict = to_dict(one("src.dict"))
            self.trg_dict = to_dict(one("trg.dict"))
            data_lines = one(member_suffix)

        def pad(ids):
            row = np.full((seq_len,), self.END, np.int64)
            n_ids = min(len(ids), seq_len)
            row[:n_ids] = ids[:seq_len]
            return row, n_ids

        src_rows, trg_rows, trg_next_rows = [], [], []
        src_lens, trg_lens = [], []
        for raw in data_lines:
            parts = raw.strip().split("\t")
            if len(parts) != 2:
                continue
            src_ids = [self.src_dict.get(w, self.UNK)
                       for w in ["<s>"] + parts[0].split() + ["<e>"]]
            t_words = [self.trg_dict.get(w, self.UNK)
                       for w in parts[1].split()]
            if len(src_ids) > self._MAX_LEN or len(t_words) > self._MAX_LEN:
                continue
            trg_ids = [self.START] + t_words
            trg_next = t_words + [self.END]
            s_row, s_len = pad(src_ids)
            t_row, t_len = pad(trg_ids)
            tn_row, _ = pad(trg_next)
            src_rows.append(s_row)
            trg_rows.append(t_row)
            trg_next_rows.append(tn_row)
            src_lens.append(s_len)
            trg_lens.append(t_len)
        if not src_rows:
            raise ValueError(f"wmt14 {mode}: no parseable pairs")
        self.src = np.stack(src_rows)
        self.trg = np.stack(trg_rows)
        self.trg_next = np.stack(trg_next_rows)
        self.src_len = np.asarray(src_lens, np.int64)
        self.trg_len = np.asarray(trg_lens, np.int64)

    def __len__(self):
        return len(self.src)

    def __getitem__(self, i):
        return (self.src[i], self.trg[i], self.trg_next[i],
                self.src_len[i], self.trg_len[i])


class MQ2007(Dataset):
    """LETOR MQ2007 learning-to-rank (ref: dataset/mq2007.py — parses
    "rel qid:N 1:v .. 46:v #docid" lines; pairwise/listwise readers).

    Dense layout: per-row (features [46], relevance, query_id); use
    ``query_groups()`` for listwise batching (contiguous row ranges per
    query, the analogue of the reference's per-query yield).
    """

    _URL = ("https://download.microsoft.com/download/E/7/E/"
            "E7EABEF1-4C7B-4E31-ACE5-73927950ED5E/Querylevelnorm.rar")
    N_FEATURES = 46

    def __init__(self, mode: str = "train",
                 data_home: Optional[str] = None) -> None:
        if mode == "synthetic":
            rng = np.random.default_rng(23)
            n = 120
            self.features = rng.normal(0, 1, (n, self.N_FEATURES)) \
                .astype(np.float32)
            self.labels = rng.integers(0, 3, (n,)).astype(np.int64)
            self.qids = np.repeat(np.arange(n // 8), 8).astype(np.int64)[:n]
            return
        home = data_home or os.path.join(DATA_HOME(), "mq2007")
        fname = {"train": "train.txt", "val": "vali.txt",
                 "test": "test.txt"}[mode]
        path = _require(os.path.join(home, fname), self._URL)
        feats, labels, qids = [], [], []
        with open(path) as f:
            for line in f:
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                parts = line.split()
                labels.append(int(parts[0]))
                qids.append(int(parts[1].split(":", 1)[1]))
                row = np.zeros((self.N_FEATURES,), np.float32)
                for tok in parts[2:]:
                    k, v = tok.split(":", 1)
                    idx = int(k) - 1
                    if 0 <= idx < self.N_FEATURES:
                        row[idx] = float(v)
                feats.append(row)
        self.features = np.stack(feats)
        self.labels = np.asarray(labels, np.int64)
        self.qids = np.asarray(qids, np.int64)

    def query_groups(self):
        """[(qid, start, end)] contiguous ranges (listwise batching)."""
        out = []
        start = 0
        for i in range(1, len(self.qids) + 1):
            if i == len(self.qids) or self.qids[i] != self.qids[start]:
                out.append((int(self.qids[start]), start, i))
                start = i
        return out

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.features[i], self.labels[i], self.qids[i]


class Conll05(Dataset):
    """CoNLL-2005 semantic role labeling (ref: dataset/conll05.py —
    words.gz/props.gz pairs inside conll05st-tests.tar.gz; bracketed
    span columns convert to BIO tags; one example per predicate).

    Zero-egress adaptation: word/tag dicts build from the parsed corpus
    (frequency-ranked, <unk>=0 like the reference's UNK_IDX) instead of
    the reference's downloaded dict files. Yields dense padded
    (word_ids [T], predicate_mark [T], tag_ids [T], length) — the exact
    input contract of models.SRLBiLSTMCRF.
    """

    _URL = ("http://paddlemodels.bj.bcebos.com/conll05st/"
            "conll05st-tests.tar.gz")

    def __init__(self, mode: str = "test", seq_len: int = 64,
                 data_home: Optional[str] = None,
                 words_member: str = ("conll05st-release/test.wsj/words/"
                                      "test.wsj.words.gz"),
                 props_member: str = ("conll05st-release/test.wsj/props/"
                                      "test.wsj.props.gz")) -> None:
        self.seq_len = seq_len
        if mode not in ("test", "synthetic"):
            raise ValueError(
                f"Conll05 mode={mode!r}: the public CoNLL-05 release "
                "ships only the test splits (conll05st-tests.tar.gz); "
                "use mode='test' (default members) or 'synthetic'")
        if mode == "synthetic":
            rng = np.random.default_rng(29)
            n, v, t = 64, 120, 9
            self.word_dict = {f"w{i}": i for i in range(v)}
            self.label_dict = {f"T{i}": i for i in range(t)}
            self.words = rng.integers(1, v, (n, seq_len)).astype(np.int64)
            self.marks = (rng.random((n, seq_len)) < 0.1).astype(np.int64)
            self.tags = rng.integers(0, t, (n, seq_len)).astype(np.int64)
            self.lengths = np.full((n,), seq_len, np.int64)
            return
        home = data_home or os.path.join(DATA_HOME(), "conll05")
        path = _require(os.path.join(home, "conll05st-tests.tar.gz"),
                        self._URL)
        sentences = self._parse(path, words_member, props_member)
        # dicts: <unk>=0, then frequency-ranked words (ref UNK_IDX = 0)
        freq: dict = {}
        tagset = set()
        for words, preds in sentences:
            for w in words:
                freq[w] = freq.get(w, 0) + 1
            for _, bio in preds:
                tagset.update(bio)
        self.word_dict = {"<unk>": 0}
        for w, _ in sorted(freq.items(), key=lambda kv: (-kv[1], kv[0])):
            self.word_dict[w] = len(self.word_dict)
        self.label_dict = {t: i for i, t in enumerate(sorted(tagset))}
        rows_w, rows_m, rows_t, lens = [], [], [], []
        for words, preds in sentences:
            wid = [self.word_dict.get(w, 0) for w in words]
            for verb_idx, bio in preds:
                n_tok = min(len(words), seq_len)
                w_row = np.zeros((seq_len,), np.int64)
                m_row = np.zeros((seq_len,), np.int64)
                t_row = np.zeros((seq_len,), np.int64)
                w_row[:n_tok] = wid[:seq_len]
                if verb_idx < seq_len:
                    m_row[verb_idx] = 1
                t_row[:n_tok] = [self.label_dict[b]
                                 for b in bio[:seq_len]]
                rows_w.append(w_row)
                rows_m.append(m_row)
                rows_t.append(t_row)
                lens.append(n_tok)
        self.words = np.stack(rows_w)
        self.marks = np.stack(rows_m)
        self.tags = np.stack(rows_t)
        self.lengths = np.asarray(lens, np.int64)

    @staticmethod
    def _parse(path, words_member, props_member):
        """[(words, [(verb_index, bio_tags)])] per sentence."""
        with tarfile.open(path, "r:*") as tar:
            wf = tar.extractfile(words_member)
            pf = tar.extractfile(props_member)
            words_text = gzip.decompress(wf.read()).decode("utf-8")
            props_text = gzip.decompress(pf.read()).decode("utf-8")
        w_lines = words_text.splitlines()
        p_lines = props_text.splitlines()
        if len(w_lines) != len(p_lines):
            raise ValueError(
                f"conll05 words/props line counts differ "
                f"({len(w_lines)} vs {len(p_lines)}) — mispaired or "
                "truncated files would silently misalign every tag")
        sentences = []
        cur_words: list = []
        cur_props: list = []
        for wline, pline in zip(w_lines, p_lines):
            w = wline.strip()
            p = pline.strip().split()
            if not w:  # sentence boundary
                if cur_words:
                    sentences.append(
                        Conll05._finish(cur_words, cur_props))
                cur_words, cur_props = [], []
                continue
            cur_words.append(w)
            cur_props.append(p)
        if cur_words:
            sentences.append(Conll05._finish(cur_words, cur_props))
        return sentences

    @staticmethod
    def _finish(words, props):
        """props rows: [verb_lemma_or_-, span_col_per_predicate...];
        bracket spans -> BIO (the reference's corpus_reader walk)."""
        n_pred = len(props[0]) - 1 if props else 0
        preds = []
        for col in range(1, n_pred + 1):
            bio = []
            cur = None
            verb_idx = 0
            for i, row in enumerate(props):
                tok = row[col]
                if tok.startswith("("):
                    tag = tok[1:].split("*", 1)[0]
                    bio.append("B-" + tag)
                    cur = tag
                    if tag == "V":
                        verb_idx = i
                    if tok.endswith(")"):
                        cur = None
                elif cur is not None:
                    bio.append("I-" + cur)
                    if tok.endswith(")"):
                        cur = None
                else:
                    bio.append("O")
            preds.append((verb_idx, bio))
        return words, preds

    def __len__(self):
        return len(self.words)

    def __getitem__(self, i):
        return (self.words[i], self.marks[i], self.tags[i],
                self.lengths[i])


class Flowers(Dataset):
    """Oxford 102 flowers (ref: dataset/flowers.py — 102flowers.tgz of
    jpg/*.jpg, imagelabels.mat 1-based labels, setid.mat split ids).

    Images decode+resize at access time (PIL), [C, H, W] float32 in
    [0, 1]; labels shift to 0-based.
    """

    _URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
            "102flowers.tgz (+ imagelabels.mat, setid.mat)")

    def __init__(self, mode: str = "train", image_size: int = 64,
                 transform=None, data_home: Optional[str] = None) -> None:
        self.image_size = image_size
        self.transform = transform
        if mode == "synthetic":
            rng = np.random.default_rng(31)
            n = 32
            self.images = rng.random((n, 3, image_size, image_size)) \
                .astype(np.float32)
            self.labels = rng.integers(0, 102, (n,)).astype(np.int64)
            return
        self.images = None
        import scipy.io as sio
        home = data_home or os.path.join(DATA_HOME(), "flowers")
        tgz = _require(os.path.join(home, "102flowers.tgz"), self._URL)
        labels_mat = _require(os.path.join(home, "imagelabels.mat"),
                              self._URL)
        setid_mat = _require(os.path.join(home, "setid.mat"), self._URL)
        all_labels = sio.loadmat(labels_mat)["labels"].ravel() - 1
        splits = sio.loadmat(setid_mat)
        key = {"train": "trnid", "val": "valid", "test": "tstid"}[mode]
        ids = splits[key].ravel()  # 1-based image ids
        self._tgz = tgz
        self._ids = ids
        self.labels = all_labels[ids - 1].astype(np.int64)
        # ONE long-lived TarFile per dataset: reopening a .tgz per item
        # would re-decompress from byte 0 on every member seek (gzip has
        # no random access) — O(archive) work per sample. Opened LAZILY
        # per process (not here) so the dataset pickles cleanly into
        # multiprocess DataLoader workers; each process gets its own
        # handle on first access.
        self._tar = None
        self._members = None
        self._tar_lock = None

    def __getstate__(self):
        # drop the per-process tar handle/lock; workers reopen lazily
        state = self.__dict__.copy()
        state["_tar"] = state["_members"] = state["_tar_lock"] = None
        return state

    _TAR_INIT_LOCK = __import__("threading").Lock()

    def _ensure_tar(self):
        if self._tar is not None and self._tar_lock is not None:
            return
        with Flowers._TAR_INIT_LOCK:  # two threads racing first access
            if self._tar_lock is None:
                self._tar_lock = __import__("threading").Lock()
            if self._tar is None:
                self._members = None
                tar = tarfile.open(self._tgz, "r:*")
                self._members = {m.name: m for m in tar.getmembers()
                                 if m.name.endswith(".jpg")}
                self._tar = tar

    def _load_image(self, image_id: int) -> np.ndarray:
        from PIL import Image
        name = f"jpg/image_{image_id:05d}.jpg"
        self._ensure_tar()
        with self._tar_lock:  # TarFile seeks are not thread-safe
            f = self._tar.extractfile(self._members[name])
            data = f.read()
        img = Image.open(io.BytesIO(data)).convert("RGB")
        img = img.resize((self.image_size, self.image_size))
        arr = np.asarray(img, np.float32) / 255.0
        return np.transpose(arr, (2, 0, 1))

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        if self.images is not None:  # synthetic
            img = self.images[i]
        else:
            img = self._load_image(int(self._ids[i]))
        if self.transform is not None:
            img = self.transform(img)
        return img, self.labels[i]


class VOC2012(Dataset):
    """PASCAL VOC2012 detection (ref: dataset/voc2012.py — VOCdevkit
    JPEGImages + Annotations XML; the reference yields segmentation,
    PaddleCV's detection readers yield boxes — this serves the
    detection family, feeding models.SSDLite directly).

    Per item: (image [3, S, S] float32, gt_boxes [max_boxes, 4]
    normalized corners 0-padded, gt_labels [max_boxes] with -1 padding;
    class ids 1..20, 0 reserved for background). Images with MORE than
    ``max_boxes`` objects are truncated to the first max_boxes (raise
    the limit for crowded-scene training — VOC has images with 40+
    boxes; the default 20 covers ~99% of trainval).
    """

    _URL = ("http://host.robots.ox.ac.uk/pascal/VOC/voc2012/"
            "VOCtrainval_11-May-2012.tar")
    CLASSES = ("aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
               "car", "cat", "chair", "cow", "diningtable", "dog",
               "horse", "motorbike", "person", "pottedplant", "sheep",
               "sofa", "train", "tvmonitor")

    def __init__(self, mode: str = "train", image_size: int = 128,
                 max_boxes: int = 20,
                 data_home: Optional[str] = None) -> None:
        self.image_size = image_size
        self.max_boxes = max_boxes
        self._cls_id = {c: i + 1 for i, c in enumerate(self.CLASSES)}
        if mode == "synthetic":
            rng = np.random.default_rng(37)
            n = 16
            self.images = rng.random((n, 3, image_size, image_size)) \
                .astype(np.float32)
            self.boxes = np.zeros((n, max_boxes, 4), np.float32)
            self.labels = np.full((n, max_boxes), -1, np.int64)
            for i in range(n):
                k = rng.integers(1, 4)
                c = rng.uniform(0.2, 0.8, (k, 2))
                wh = rng.uniform(0.05, 0.15, (k, 2))
                self.boxes[i, :k] = np.concatenate([c - wh, c + wh], 1)
                self.labels[i, :k] = rng.integers(1, 21, (k,))
            return
        self.images = None
        home = data_home or os.path.join(DATA_HOME(), "voc2012")
        tar_path = _require(
            os.path.join(home, "VOCtrainval_11-May-2012.tar"), self._URL)
        self._tar_path = tar_path
        base = "VOCdevkit/VOC2012"
        split = {"train": "train", "val": "val",
                 "trainval": "trainval"}[mode]
        with tarfile.open(tar_path, "r:*") as tar:
            names = tar.extractfile(
                f"{base}/ImageSets/Main/{split}.txt") \
                .read().decode().split()
            self._names = names
            self._members = {m.name: m for m in tar.getmembers()}
        self._base = base

    def _parse_item(self, name: str):
        import xml.etree.ElementTree as ET

        from PIL import Image
        with tarfile.open(self._tar_path, "r:*") as tar:
            xml_bytes = tar.extractfile(self._members[
                f"{self._base}/Annotations/{name}.xml"]).read()
            jpg_bytes = tar.extractfile(self._members[
                f"{self._base}/JPEGImages/{name}.jpg"]).read()
        root = ET.fromstring(xml_bytes)
        w = float(root.find("size/width").text)
        h = float(root.find("size/height").text)
        boxes = np.zeros((self.max_boxes, 4), np.float32)
        labels = np.full((self.max_boxes,), -1, np.int64)
        k = 0
        for obj in root.iter("object"):
            if k >= self.max_boxes:
                break
            cls = obj.find("name").text.strip()
            if cls not in self._cls_id:
                continue
            bb = obj.find("bndbox")
            x1 = float(bb.find("xmin").text) / w
            y1 = float(bb.find("ymin").text) / h
            x2 = float(bb.find("xmax").text) / w
            y2 = float(bb.find("ymax").text) / h
            boxes[k] = (x1, y1, x2, y2)
            labels[k] = self._cls_id[cls]
            k += 1
        img = Image.open(io.BytesIO(jpg_bytes)).convert("RGB") \
            .resize((self.image_size, self.image_size))
        arr = np.transpose(np.asarray(img, np.float32) / 255.0,
                           (2, 0, 1))
        return arr, boxes, labels

    def __len__(self):
        return len(self.labels) if self.images is not None \
            else len(self._names)

    def __getitem__(self, i):
        if self.images is not None:  # synthetic
            return self.images[i], self.boxes[i], self.labels[i]
        return self._parse_item(self._names[i])


def _freq_vocab_and_pad(docs_words, freq, seq_len):
    """Shared text contract: frequency-ranked vocab (ties
    lexicographic), ids from 2 (0=pad, 1=OOV), dense pad/truncate to
    seq_len. One definition so Imdb/MovieReviews cannot drift."""
    vocab = sorted(freq, key=lambda w: (-freq[w], w))
    word_idx = {w: i + 2 for i, w in enumerate(vocab)}
    docs = np.zeros((len(docs_words), seq_len), np.int64)
    for i, words in enumerate(docs_words):
        ids = [word_idx.get(w, 1) for w in words[:seq_len]]
        docs[i, :len(ids)] = ids
    return word_idx, docs


class MovieReviews(Dataset):
    """NLTK movie_reviews sentiment corpus (ref: dataset/sentiment.py —
    the reference shells out to nltk.download; zero-egress here: stage
    the corpus directory (movie_reviews/{pos,neg}/*.txt) and this
    parses it directly, same frequency-ranked vocab + (ids, 0/1 label)
    contract, dense padded like Imdb).
    """

    _URL = ("https://www.nltk.org/nltk_data/ (movie_reviews corpus; "
            "extract so DATA_HOME/sentiment/movie_reviews/{pos,neg} "
            "hold the .txt files)")

    def __init__(self, mode: str = "train", seq_len: int = 256,
                 holdout: float = 0.1,
                 data_home: Optional[str] = None) -> None:
        self.seq_len = seq_len
        if mode == "synthetic":
            rng = np.random.default_rng(41)
            n, vocab = 64, 300
            self.word_idx = {f"w{i}": i for i in range(vocab)}
            self.docs = rng.integers(2, vocab, (n, seq_len)) \
                .astype(np.int64)
            self.labels = (np.arange(n) % 2).astype(np.int64)
            self.docs[self.labels == 1] //= 2
            return
        home = data_home or os.path.join(DATA_HOME(), "sentiment")
        root = _require(os.path.join(home, "movie_reviews"), self._URL)
        docs_words, labels = [], []
        freq: dict = {}
        for label, sub in ((1, "pos"), (0, "neg")):
            subdir = os.path.join(root, sub)
            if not os.path.isdir(subdir):
                raise FileNotFoundError(
                    f"expected {subdir} with .txt reviews ({self._URL})")
            for fname in sorted(os.listdir(subdir)):
                if not fname.endswith(".txt"):
                    continue
                with open(os.path.join(subdir, fname),
                          encoding="utf-8", errors="ignore") as f:
                    words = f.read().lower().split()
                for w in words:
                    freq[w] = freq.get(w, 0) + 1
                docs_words.append(words)
                labels.append(label)
        self.word_idx, docs = _freq_vocab_and_pad(docs_words, freq,
                                                  seq_len)
        labels_np = np.asarray(labels, np.int64)
        # deterministic STRATIFIED split: a per-class shuffled
        # round-robin pick, so both classes appear in both splits even
        # for tiny corpora (an iid Bernoulli draw cannot promise that)
        take_test = np.zeros(len(docs), bool)
        rng = np.random.default_rng(0)
        for cls in (0, 1):
            idx = np.flatnonzero(labels_np == cls)
            rng.shuffle(idx)
            n_test = max(1, int(round(len(idx) * holdout))) \
                if len(idx) > 1 else 0
            take_test[idx[:n_test]] = True
        pick = take_test if mode == "test" else ~take_test
        self.docs = docs[pick]
        self.labels = labels_np[pick]

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return self.docs[i], self.labels[i]
