"""``padding_frac.train``, read in the 1bw training cell:
it moves that cell's rate, ``words_per_s.1bw``."""
from w2vbench import manifest

read = manifest.reader("padding_frac.train")
