"""The paper's core, ported to PyTorch: the CNN backbones, the compressor
(Eq. 1-4: serving and two-stage training), JALAD and its Huffman codec, the
overhead model, split tables and fleets."""
