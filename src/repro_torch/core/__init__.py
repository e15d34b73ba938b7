"""SPARQLe core: quantization, the LSB4/MSB4/PBM codec, clipping, wire
accounting and the quantized linear (torch twins of ``repro.core``)."""
