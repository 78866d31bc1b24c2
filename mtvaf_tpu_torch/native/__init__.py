"""The C++ host runtime: batch WordPiece (``wordpiece.cc``) and the image
op (``image_ops.cc``), built with ``g++`` at first use (:mod:`.build`) and
bound with ctypes (:mod:`.binding`); :mod:`.reference` is the image op's
plain numpy version."""
