"""Phoneme inventory for phonetic posteriorgrams.

40 categories: 39 CMU-style phones plus silence, in the canonical order used by
trained checkpoints (reference: ppgs/phonemes.py:10-50). Index order is part of
the on-disk model contract and must never change.
"""

# The silence token string used by pypar-style alignments
SILENCE = '<silent>'

# Our 40 phoneme categories (in order)
PHONEMES = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'b', 'ch', 'd', 'dh',
    'eh', 'er', 'ey', 'f', 'g', 'hh', 'ih', 'iy', 'jh', 'k',
    'l', 'm', 'n', 'ng', 'ow', 'oy', 'p', 'r', 's', 'sh',
    't', 'th', 'uh', 'uw', 'v', 'w', 'y', 'z', 'zh', SILENCE,
]

NUM_PHONEMES = len(PHONEMES)

# Mapping between phonemes and integer category indices
PHONEME_TO_INDEX_MAPPING = {phone: i for i, phone in enumerate(PHONEMES)}

# Voiced subset (reference: ppgs/phonemes.py:60-89)
VOICED = [
    'aa', 'ae', 'ah', 'ao', 'aw', 'ay', 'eh', 'er', 'ey', 'hh',
    'ih', 'iy', 'jh', 'l', 'm', 'n', 'ng', 'ow', 'oy', 'r',
    'uh', 'uw', 'v', 'w', 'y', 'z', 'zh',
]

# The permutation of our phonemes used by the Charsiu frame classifier
# (reference: ppgs/phonemes.py:97-138)
CHARSIU_PHONE_ORDER = [
    SILENCE, 'ng', 'f', 'm', 'ae', 'r', 'uw', 'n', 'iy', 'aw',
    'v', 'uh', 'ow', 'aa', 'er', 'hh', 'z', 'k', 'ch', 'w',
    'ey', 'zh', 't', 'eh', 'y', 'ah', 'b', 'p', 'th', 'dh',
    'ao', 'g', 'l', 'jh', 'oy', 'sh', 'd', 'ay', 's', 'ih',
]
CHARSIU_PERMUTE = [CHARSIU_PHONE_ORDER.index(phone) for phone in PHONEMES]

# Mapping from the TIMIT phoneme set to our phoneme set. Stops marked
# 'bck<...>' are closures backfilled from the following release phone
# (reference: ppgs/phonemes.py:142-206).
TIMIT_TO_ARCTIC_MAPPING = {
    'aa': 'aa',
    'ae': 'ae',
    'ah': 'ah',
    'ao': 'ao',
    'aw': 'aw',
    'ax': 'ah',
    'ax-h': 'ah',
    'axr': 'er',
    'ay': 'ay',
    'b': 'b',
    'bcl': 'bck<b>',
    'ch': 'ch',
    'd': 'd',
    'dcl': 'bck<d,jh>',
    'dh': 'dh',
    'dx': 'd',
    'eh': 'eh',
    'el': 'l',
    'em': 'm',
    'en': 'n',
    'eng': 'ng',
    'epi': SILENCE,
    'er': 'er',
    'ey': 'ey',
    'f': 'f',
    'g': 'g',
    'gcl': 'bck<g>',
    'h#': SILENCE,
    'hh': 'hh',
    'hv': 'hh',
    'ih': 'ih',
    'ix': 'ih',
    'iy': 'iy',
    'jh': 'jh',
    'k': 'k',
    'kcl': 'bck<k>',
    'l': 'l',
    'm': 'm',
    'n': 'n',
    'ng': 'ng',
    'nx': 'n',
    'ow': 'ow',
    'oy': 'oy',
    'p': 'p',
    'pau': SILENCE,
    'pcl': 'bck<p>',
    'q': 't',
    'r': 'r',
    's': 's',
    'sh': 'sh',
    't': 't',
    'tcl': 'bck<t,ch>',
    'th': 'th',
    'uh': 'uh',
    'uw': 'uw',
    'ux': 'uw',
    'v': 'v',
    'w': 'w',
    'y': 'y',
    'z': 'z',
    'zh': 'zh',
}
