"""Object-word vocabulary (67 classes) and sentence -> object-word extraction.

The PyTorch port's own copy of `nafae_tpu/data/vocab.py`: word ids must
agree between the two packages, so keep them in step.

The reference uses the YouCook2-BoundingBox 67-class object dictionary
(SURVEY.md L46, L133). The real class list ships with the YouCook2-BB
annotations; `DEFAULT_CLASSES` below is a documented stand-in with the right
cardinality — load the real list with `Vocab.from_file` when annotations are
available. Class names may be
multi-word ("bell pepper" / "bell_pepper"); extraction matches them as
n-grams over the sentence tokens, longest match first.
"""

from __future__ import annotations

import re

# 67 cooking-object classes (stand-in list; replace via Vocab.from_file when the
# real YouCook2-BB class file is available — cardinality and semantics match).
DEFAULT_CLASSES = [
    "pan", "pot", "bowl", "plate", "knife", "spoon", "fork", "cup", "glass",
    "oven", "stove", "blender", "board", "tray", "lid", "jar", "bottle",
    "oil", "butter", "salt", "pepper", "sugar", "flour", "water", "milk",
    "cream", "cheese", "egg", "chicken", "beef", "pork", "bacon", "sausage",
    "fish", "shrimp", "rice", "pasta", "noodle", "bread", "dough", "tortilla",
    "onion", "garlic", "tomato", "potato", "carrot", "pepper_bell", "mushroom",
    "lettuce", "cabbage", "cucumber", "corn", "bean", "pea", "spinach",
    "broccoli", "lemon", "lime", "apple", "banana", "sauce", "soup", "salad",
    "ginger", "cilantro", "parsley", "seasoning",
]
assert len(DEFAULT_CLASSES) == 67

_TOKEN_RE = re.compile(r"[a-z_]+")
_SPLIT_RE = re.compile(r"[\s_]+")


def _plural_forms(w: str) -> list[str]:
    """Regular English plurals: onion->onions, dish->dishes, berry->berries."""
    out = [w + "s"]
    if w.endswith(("s", "sh", "ch", "x", "z", "o")):
        out.append(w + "es")
    if w.endswith("y") and len(w) > 1 and w[-2] not in "aeiou":
        out.append(w[:-1] + "ies")
    return out


def vocab_from_config(data_cfg) -> "Vocab":
    """The canonical vocab for a config: data.classes_file when set, else
    the built-in stand-in class list. Every consumer (extract, GloVe init,
    visualize) must build its vocab here so word ids stay consistent
    across extraction, training, and rendering."""
    cf = getattr(data_cfg, "classes_file", "") or ""
    return Vocab.from_file(cf) if cf else Vocab()


class Vocab:
    """Maps object words/phrases <-> class ids; extracts them from sentences.

    Multi-word classes ("bell pepper", "bell_pepper") are canonicalized to
    token tuples and matched as n-grams; plural aliases apply to the LAST
    token of a phrase ("bell peppers" -> "bell pepper").
    """

    def __init__(self, classes: list[str] | None = None):
        self.classes = list(classes) if classes is not None else list(DEFAULT_CLASSES)
        self.word_to_id = {w: i for i, w in enumerate(self.classes)}
        self._phrase_to_id: dict[tuple[str, ...], int] = {}
        self._max_n = 1
        # two passes: EVERY exact class name is registered before any
        # auto-plural alias, so a class whose literal name equals another
        # class's plural (e.g. "pepper" and "peppers" both in the list)
        # keeps its own id instead of being shadowed by the alias
        tok_lists = []
        for w, i in self.word_to_id.items():
            toks = tuple(t for t in _SPLIT_RE.split(w.strip()) if t)
            if not toks:
                continue
            self._max_n = max(self._max_n, len(toks))
            self._phrase_to_id.setdefault(toks, i)
            tok_lists.append((toks, i))
        for toks, i in tok_lists:
            for alias in _plural_forms(toks[-1]):
                self._phrase_to_id.setdefault(toks[:-1] + (alias,), i)

    def __len__(self) -> int:
        return len(self.classes)

    @classmethod
    def from_file(cls, path: str) -> "Vocab":
        # lowercase: lookup() lowercases tokens, so a capitalized class-file
        # entry would otherwise never match anything
        with open(path) as f:
            classes = [ln.strip().lower() for ln in f if ln.strip()]
        return cls(classes)

    def lookup(self, token: str) -> int | None:
        """Word or phrase ('bell pepper' / 'bell_pepper') -> class id."""
        toks = tuple(t for t in _SPLIT_RE.split(token.lower().strip()) if t)
        return self._phrase_to_id.get(toks)

    def extract(self, sentence: str, max_words: int | None = None,
                dedup: bool = True) -> list[int]:
        """Sentence -> ordered object-word class ids (SURVEY.md L133).

        Greedy longest-match n-gram scan, so 'chop the bell pepper' yields
        the 'bell pepper' class, not the bare 'pepper' class, while
        'add pepper' still yields 'pepper'.
        """
        toks: list[str] = []
        for t in _TOKEN_RE.findall(sentence.lower()):
            toks.extend(x for x in t.split("_") if x)
        ids, seen = [], set()
        i = 0
        while i < len(toks):
            hit = None
            for n in range(min(self._max_n, len(toks) - i), 0, -1):
                cid = self._phrase_to_id.get(tuple(toks[i:i + n]))
                if cid is not None:
                    hit = (cid, n)
                    break
            if hit is None:
                i += 1
                continue
            cid, n = hit
            i += n
            if dedup and cid in seen:
                continue
            ids.append(cid)
            seen.add(cid)
            if max_words is not None and len(ids) >= max_words:
                break
        return ids
