"""Docker-style adjective_scientist run-name generator (counterpart of
``pytorch_toolbelt_tpu/utils/namesgenerator.py``)."""

import random

__all__ = ["get_random_name"]

ADJECTIVES = [
    "admiring", "adoring", "agitated", "amazing", "angry", "awesome", "blissful",
    "bold", "boring", "brave", "busy", "charming", "clever", "cool", "compassionate",
    "competent", "condescending", "confident", "cranky", "crazy", "dazzling",
    "determined", "distracted", "dreamy", "eager", "ecstatic", "elastic", "elated",
    "elegant", "eloquent", "epic", "fervent", "festive", "flamboyant", "focused",
    "friendly", "frosty", "gallant", "gifted", "goofy", "gracious", "happy",
    "hardcore", "heuristic", "hopeful", "hungry", "infallible", "inspiring",
    "jolly", "jovial", "keen", "kind", "laughing", "loving", "lucid", "magical",
    "mystifying", "modest", "musing", "naughty", "nervous", "nifty", "nostalgic",
    "objective", "optimistic", "peaceful", "pedantic", "pensive", "practical",
    "priceless", "quirky", "quizzical", "recursing", "relaxed", "reverent",
    "romantic", "sad", "serene", "sharp", "silly", "sleepy", "stoic", "stupefied",
    "suspicious", "sweet", "tender", "thirsty", "trusting", "unruffled", "upbeat",
    "vibrant", "vigilant", "vigorous", "wizardly", "wonderful", "xenodochial",
    "youthful", "zealous", "zen",
]

SCIENTISTS = [
    "albattani", "allen", "almeida", "agnesi", "archimedes", "ardinghelli",
    "aryabhata", "austin", "babbage", "banach", "bardeen", "bartik", "bassi",
    "bell", "benz", "bhabha", "bhaskara", "blackwell", "bohr", "booth", "borg",
    "bose", "boyd", "brahmagupta", "brattain", "brown", "carson", "chandrasekhar",
    "chebyshev", "clarke", "colden", "cori", "cray", "curie", "darwin", "davinci",
    "dijkstra", "dirac", "driscoll", "dubinsky", "easley", "edison", "einstein",
    "elion", "engelbart", "euclid", "euler", "fermat", "fermi", "feynman",
    "franklin", "galileo", "gates", "goldberg", "goldstine", "goodall", "hamilton",
    "hawking", "heisenberg", "hermann", "herschel", "hertz", "heyrovsky", "hodgkin",
    "hoover", "hopper", "hugle", "hypatia", "jackson", "jang", "jennings", "jepsen",
    "johnson", "joliot", "jones", "kalam", "kare", "keller", "kepler", "khorana",
    "kilby", "kirch", "knuth", "kowalevski", "lalande", "lamarr", "lamport",
    "leakey", "leavitt", "lewin", "lichterman", "liskov", "lovelace", "lumiere",
    "mahavira", "mayer", "mccarthy", "mcclintock", "mclean", "mcnulty", "meitner",
    "mendel", "mendeleev", "mestorf", "minsky", "mirzakhani", "morse", "murdock",
    "neumann", "newton", "nightingale", "nobel", "noether", "northcutt", "noyce",
    "panini", "pare", "pasteur", "payne", "perlman", "pike", "poincare", "poitras",
    "ptolemy", "raman", "ramanujan", "ride", "ritchie", "roentgen", "rosalind",
    "saha", "sammet", "shannon", "shaw", "shirley", "shockley", "sinoussi",
    "snyder", "spence", "stallman", "stonebraker", "swanson", "swartz", "swirles",
    "tesla", "thompson", "torvalds", "turing", "varahamihira", "visvesvaraya",
    "volhard", "villani", "wescoff", "wiles", "williams", "wilson", "wing",
    "wozniak", "wright", "yalow", "yonath",
]


def get_random_name(sep: str = "_", rng: random.Random = None) -> str:
    """adjective_scientist, e.g. 'focused_noether'."""
    rng = rng or random
    name = f"{rng.choice(ADJECTIVES)}{sep}{rng.choice(SCIENTISTS)}"
    if name == f"boring{sep}wozniak":  # Steve Wozniak is not boring (docker tradition)
        return get_random_name(sep, rng)
    return name
