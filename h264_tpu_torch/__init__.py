"""h264_tpu_torch — the H.264/AVC encoder ported to PyTorch and CUDA for an
NVIDIA H100, beside the JAX package ``h264_tpu`` that it is held against
(integer outputs equal, Annex-B streams byte-identical).

It imports torch, numpy and the standard library, never JAX nor the JAX
package.  It mirrors the reference package's layout:
  bitstream/, syntax/, entropy/   copies of the host syntax and CABAC code
  decoder/                        the parse-state and picture holders
  ops/                            exact transforms / quant (torch), deblock
  native/                         the host C runtime (CABAC writer, deblock)
  encoder/                        rd.py, rd_p.py, rd_b.py (the I, P and B
                                  pipelines, plain PyTorch beside the
                                  kernels), encoder.py (H264Encoder),
                                  fills.py, syntax_cabac.py
  kernels/, csrc/                 hand-written CUDA kernels and wrappers
  device.py                       device policy and the kernel build
  convert.py                      reference entries and tables carried in

Ported so far: the all-intra, IPPP and IPB CABAC encodes of the fast RD
path, the bench configuration included (ROADMAP Queue 1).
"""

__version__ = "0.1.0"
