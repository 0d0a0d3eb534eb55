"""Procedural name generation: universe bodies, buildings/businesses,
stores, people, and book titles (port of `3dworld_tpu/utils/names.py`,
host code, copied whole).

Transcribed behavior (tables are behavioral parameters, like the weapon
and texture tables):
  Universe_name.cpp:5-122    phoneme-chain generator (alternating vowel/
                             consonant chunks with the exact termination
                             rule) + the universe and city phoneme sets
  pedestrians.cpp:25-162     order-2 Markov person-name generator over
                             the shipped text_data/{male,female}_names
                             lists, seeded per-person by ssn
  building_names_signs.cpp:17-133
                             family/company/business name formats and
                             the store_names.txt category file

The shipped data files (text_data/*.txt) are loaded from the reference
tree like the scene configs and texture assets are; everything degrades
to the generative models when the files are absent.
"""

from __future__ import annotations

import os
from functools import lru_cache

from .rng import RandGen
from .assets import asset_path

TEXT_DATA_DIR = asset_path("text_data") or ""


# ---------------------------------------------------------------------------
# phoneme-chain generator (Universe_name.cpp name_gen_t)
# ---------------------------------------------------------------------------

class PhonemeNameGen:
    """Alternating vowel/consonant phoneme chains: starts with a
    consonant 90% of the time, draws from start/middle/ending chunk
    tables, and terminates by the reference's exact length/roll rule
    (Universe_name.cpp:33-47)."""

    def __init__(self, v_start, v_middle, v_ending, c_start, c_middle,
                 c_ending):
        self.start = (v_start.split(), c_start.split())
        self.middle = (v_middle.split(), c_middle.split())
        self.ending = (v_ending.split(), c_ending.split())

    def gen_name(self, rg: RandGen) -> str:
        at_end = False
        vc = 1 if (rg.rand() % 100) < 90 else 0   # 1 = consonant
        name = ""
        i = 0
        while not at_end:
            at_end = (i >= 5 or len(name) >= 8
                      or (i > 1 and (rg.rand() % 100)
                          < ((10 if vc else 5) + 16 * i)))
            tbl = (self.start if i == 0
                   else (self.ending if at_end else self.middle))[vc]
            name += tbl[rg.rand() % len(tbl)]
            i += 1
            vc ^= 1
        return name[0].upper() + name[1:]


def _universe_gen() -> PhonemeNameGen:
    # Universe_name.cpp:56-77 phoneme distribution
    v_com = "a e i o u ae ai ao au ea eo eu ia ie io oa oi ou ua ui ue "
    v_str = "ii uu yu yi aia oio uai eie "
    v_beg = "aii eau ieo oau yae yea yio "
    v_mid = "aia aio aie aea iea ioa iou oai oua oue "
    v_end = "aie aye oie uie uai yai yio yea "
    c_com = "l n r s t z v b d g h k m p w x "
    c_str = "ph th ch sh zh gh bh dh jh kh lh mh rh wh "
    c_beg = ("bl br cl cr dr fl fr gl gr pl pr tr sl sr sk st sp sh sw "
             "thr fr ")
    c_mid = "bb dd ff gg ll nn mm pp rr ss tt zz xh chl chr phl phr thr shl shw "
    c_end = "ct ck nd ng nk nt rt rk rn rm rp rb rd rg rtst sh "
    return PhonemeNameGen(
        v_com + v_com + v_str + v_beg + v_beg,
        v_com + v_com + v_str + v_mid + v_mid,
        v_com + v_com + v_str + v_end + v_end,
        c_com + c_com + c_str + c_beg + c_beg,
        c_com + c_com + c_str + c_beg + c_mid + c_mid + c_end,
        c_com + c_com + c_str + c_end + c_end)


def _city_gen() -> PhonemeNameGen:
    # Universe_name.cpp:79-98 original strings
    v_com = "a e i o "
    v_str = "u ai io "
    v_beg = "au ea ei eo eu ou ya ye yo "
    v_mid = "ao au ea ee ei eo eu ia ie oa oi oo ou ue "
    v_end = "ay ee ey ia ie oo oy ue ion "
    c_com = "l n r s t "
    c_str = ("b b c c d d f f g g h h j k m m p p v w w x ch ch sp st st "
             "th th ")
    c_beg = "bl br cl cr dr fl fr gl gr ph pl pr sk sh sh tr tr wh q str thr "
    c_mid = "bb dd ff gg pp rr rr tt tt rc "
    c_end = ("ck ck ct gh ld ld ll ln ln lm lp lt mp nc nd nd ng nk rk rs "
             "rs rt rt ss ss gth nch ")
    return PhonemeNameGen(
        v_com * 5 + v_str + v_beg, v_com * 5 + v_str + v_mid,
        v_com * 5 + v_str + v_end, c_com * 4 + c_str + c_beg,
        c_com * 4 + c_str + c_beg + c_mid + c_end,
        c_com * 4 + c_str + c_end)


_UNIVERSE = _universe_gen()
_CITY = _city_gen()


def gen_random_name(rg: RandGen, min_len: int = 0,
                    for_universe: bool = False) -> str:
    """gen_random_name (Universe_name.cpp:101-110): retry until the
    minimum length is met."""
    gen = _UNIVERSE if for_universe else _CITY
    name = ""
    for _ in range(100):
        name = gen.gen_name(rg)
        if len(name) >= min_len:
            break
    return name


# ---------------------------------------------------------------------------
# order-2 Markov person names (pedestrians.cpp markov_chain_name_gen_t)
# ---------------------------------------------------------------------------

class MarkovNameGen:
    """Order-N character Markov chain over a training name list; rejects
    generated names that are too short or reproduce a real name
    (pedestrians.cpp:25-105)."""

    def __init__(self, order: int = 2):
        self.order = order
        self.prefix0 = "_" * order
        self.markov: dict = {}
        self.real = set()
        self.min_len = 1000
        self.max_len = 0

    def add_names(self, names):
        for n in names:
            self.real.add(n)
            s = self.prefix0 + n[0].lower() + n[1:] + "*"
            for i in range(len(s) - self.order):
                self.markov.setdefault(s[i:i + self.order], []).append(
                    s[i + self.order])
            self.min_len = min(self.min_len, len(n))
            self.max_len = max(self.max_len, len(n))
        self.min_len = max(self.min_len, 3)

    def _gen_inner(self, rg: RandGen) -> str:
        name = ""
        prefix = self.prefix0
        while len(name) < self.max_len:
            cands = self.markov.get(prefix)
            if not cands:
                break
            nxt = cands[0 if len(cands) == 1 else rg.rand() % len(cands)]
            if nxt == "*":
                break
            name += nxt
            prefix = prefix[1:] + nxt
        return (name[0].upper() + name[1:]) if name else "X"

    def gen_name(self, rg: RandGen) -> str:
        name = ""
        for _ in range(10):
            name = self._gen_inner(rg)
            if len(name) >= self.min_len and name not in self.real:
                break
        return name


def _load_lines(fn: str):
    if not TEXT_DATA_DIR:
        return []
    path = os.path.join(TEXT_DATA_DIR, fn)
    if not os.path.isfile(path):
        return []
    out = []
    with open(path, errors="replace") as f:
        for line in f:
            line = line.rstrip("\n")
            if line and not line.startswith("#"):
                out.append(line)
    return out


_FALLBACK_NAMES = ["Alex", "Morgan", "Sam", "Casey", "Jordan", "Riley"]


@lru_cache(maxsize=1)
def _person_gen():
    male = _load_lines("male_names.txt") or list(_FALLBACK_NAMES)
    female = _load_lines("female_names.txt") or list(_FALLBACK_NAMES)
    mg, fg = MarkovNameGen(2), MarkovNameGen(2)
    mg.add_names(male)
    fg.add_names(female)
    return male, female, mg, fg


def gen_person_name(person_id: int, is_female: bool,
                    inc_first: bool = True, inc_last: bool = True) -> str:
    """person_name_gen_t::gen_name (pedestrians.cpp:130-151): seeded by
    the person's id ('ssn'); 50% real first name, 50% Markov-generated;
    last names borrow the city phoneme generator."""
    male, female, mg, fg = _person_gen()
    rg = RandGen(person_id + 456, person_id + 123)
    rg.rand_mix()
    name = ""
    if inc_first:
        if rg.rand_bool():
            name += (fg if is_female else mg).gen_name(rg)
        else:
            names = female if is_female else male
            name += names[rg.rand() % len(names)]
    if inc_last:
        if name:
            name += " "
        name += gen_random_name(rg)
    return name


# ---------------------------------------------------------------------------
# businesses and stores (building_names_signs.cpp)
# ---------------------------------------------------------------------------

_CO_PREFIX = ["i", "Green ", "Mega", "Super ", "Omni", "e", "Hyper",
              "Global ", "Vital", "Next ", "Pacific ", "Metro", "Unity ",
              "G-", "Trans", "Infinity ", "Superior ", "Monolith ",
              "Best ", "Atlantic ", "First ", "Union ", "National "]
_CO_NAME = ["Biotic", "Info", "Data", "Solar", "Aerospace", "Motors",
            "Nano", "Online", "Circuits", "Energy", "Med", "Robotic",
            "Exports", "Security", "Systems", "Financial", "Industrial",
            "Media", "Materials", "Foods", "Networks", "Shipping",
            "Tools", "Medical", "Publishing", "Enterprises", "Audio",
            "Health", "Bank", "Imports", "Apparel", "Petroleum",
            "Studios"]
_CO_SUFFIX = ["Corp", " Inc.", "Co", "World", ".Com", " USA", " Ltd.",
              "Net", " Tech", " Labs", " Mfg.", " UK", " Unlimited",
              " One", " LLC"]


def gen_company_name(rg: RandGen) -> str:
    """pixel_city::gen_company_name (building_names_signs.cpp:33-38)."""
    cname = _CO_NAME[rg.rand() % len(_CO_NAME)]
    if rg.rand_bool():
        return _CO_PREFIX[rg.rand() % len(_CO_PREFIX)] + cname
    return cname + _CO_SUFFIX[rg.rand() % len(_CO_SUFFIX)]


@lru_cache(maxsize=1)
def _store_categories():
    """Parse text_data/store_names.txt: 'category:' headers followed by
    one name per line (building_names_signs.cpp:46-60)."""
    cats: dict = {"general": []}
    cur = "general"
    for line in _load_lines("store_names.txt"):
        if line.endswith(":"):
            cur = line[:-1].strip().lower()
            cats.setdefault(cur, [])
        else:
            cats[cur].append(line.strip())
    return cats


def choose_store_name(category: str, rg: RandGen) -> str:
    """Store sign names by category ('food', 'clothing', 'book',
    'retail', 'furniture', 'restaurant', ...)."""
    cats = _store_categories()
    names = cats.get(category.lower()) or cats.get("general") or []
    if not names:
        return gen_random_name(rg, 4)
    return names[rg.rand() % len(names)]


# building-type display names (building_defs.h btype_names subset used
# for specialized business names)
BTYPE_DISPLAY = {
    "apartment": "Apartments", "hotel": "Hotel", "hospital": "Hospital",
    "parking": "Parking", "school": "School", "police": "Police Station",
    "fire_stat": "Fire Station", "prison": "Prison", "factory": "Factory",
    "warehouse": "Warehouse", "powerplant": "Power Plant",
    "datacenter": "Datacenter", "mall": "Mall",
}


def choose_business_name(rg: RandGen, btype: str = "office") -> str:
    """choose_business_name (building_names_signs.cpp:103-133): special
    building types get '<Name> <Type>'; offices roll company names,
    acronyms, and the reference's suffix formats."""
    if btype == "parking":
        return "Parking"
    if btype == "restaurant":
        return choose_store_name("restaurant", rg)
    if btype == "datacenter" and rg.rand_float() < 0.1:
        return "Skynet"
    if btype in BTYPE_DISPLAY:
        return gen_random_name(rg, 4) + " " + BTYPE_DISPLAY[btype]
    if rg.rand_bool():
        return gen_company_name(rg)
    v = rg.rand() % 10
    if v == 0:
        return "".join(chr(ord("A") + rg.rand() % 26) for _ in range(3))
    base = gen_random_name(rg, 4)
    if v == 1:
        return base
    if v == 2:
        return base + (" Co" if rg.rand_bool() else " Company")
    if v == 3:
        return base + " Inc"
    if v == 4:
        return base + (" Ltd" if rg.rand_bool() else " Corp")
    if v == 5:
        return base + " & " + gen_random_name(rg)
    if v == 6:
        return (base + ", " + gen_random_name(rg) + ", & "
                + gen_random_name(rg))
    if v == 7:
        a = ("National " if rg.rand_bool() else "Global ") \
            if rg.rand_bool() else \
            ("United " if rg.rand_bool() else "American ")
        return a + base
    if v == 8:
        a = (" Bank" if rg.rand_bool() else " Trust") \
            if rg.rand_bool() else \
            (" Holdings" if rg.rand_bool() else " Industries")
        return base + a
    return base + " " + gen_random_name(rg)


@lru_cache(maxsize=1)
def book_titles():
    """The shipped text_data/book_titles.txt list (used to title F_BOOK
    objects, like the reference's book spines/covers)."""
    return _load_lines("book_titles.txt")


def choose_book_title(rg: RandGen) -> str:
    titles = book_titles()
    if not titles:
        return gen_random_name(rg, 4)
    return titles[rg.rand() % len(titles)]
