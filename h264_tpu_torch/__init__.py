"""h264_tpu_torch — the H.264/AVC encoder and decoder ported to PyTorch and
CUDA for an NVIDIA H100, beside the JAX package ``h264_tpu`` that it is
held against (integer outputs equal, Annex-B streams and decoded pictures
byte-identical).

It imports torch, numpy and the standard library, never JAX nor the JAX
package.  It mirrors the reference package's layout:
  bitstream/, syntax/, entropy/   copies of the host syntax and CABAC code
  decoder/                        the decoder: decoder.py (H264Decoder),
                                  the parsers, DPB, MV derivation, host
                                  reconstruction, concealment, device.py
                                  (the inter reconstruction beside K8)
  ops/                            exact transforms / quant (torch), deblock
  native/                         the host C runtime (CABAC writer and
                                  readers, CAVLC reader, recon, deblock)
  encoder/                        rd.py, rd_p.py, rd_b.py (the I, P and B
                                  pipelines, plain PyTorch beside the
                                  kernels), encoder.py (H264Encoder),
                                  fills.py, syntax_cabac.py
  kernels/, csrc/                 hand-written CUDA kernels and wrappers
  device.py                       device policy and the kernel build
  convert.py                      reference entries and tables carried in
  ldecod.py                       the decoder CLI (``python -m``)

Ported so far: the all-intra, IPPP and IPB CABAC encodes of the fast RD
path, the bench configuration included, and the decoder (ROADMAP Queue 1).
"""

__version__ = "0.1.0"
