"""``words_per_s``, read in the 1bw training cell: a metric of its own,
so that this cell's spread sets its own bound and not the text8 cell's."""
from w2vbench import manifest

read = manifest.reader("words_per_s")
