"""Frame and flow I/O of the port (counterpart of ``gqmap_tpu.io``)."""

from .flo import read_flo, write_flo
from .images import load_image, rgb2gray, imresize
from .dataset import Sequence, data_root, list_sequences, load_sequence, SEQUENCES
