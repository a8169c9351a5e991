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
                                  kernels), rd_rows.py (tile-row P
                                  slices), lossaware.py (the simulated
                                  lossy decoders), fast.py (the legacy
                                  P16x16 picture), encoder.py
                                  (H264Encoder), fills.py, syntax_cabac.py
  control/                        rate control (JVT-G012) and the
                                  leaky-bucket parameters
  parallel/                       the sharded tile-row pipelines over
                                  torch.distributed ranks (mesh, halo
                                  exchange, the GOP encoder, the dry run)
  kernels/, csrc/                 hand-written CUDA kernels and wrappers
  device.py                       device policy and the kernel build
  convert.py                      reference entries and tables carried in
  config.py                       the JM .cfg parser, the encoder's and
                                  decoder's run configurations
  lencod.py, ldecod.py            the encoder and decoder CLIs
                                  (``python -m``)
  tools/                          rtp_loss, rtpdump, benchseq (copies),
                                  profilers and built kernel inputs

Ported: the all-intra, IPPP and IPB encodes of the fast RD path (CABAC
and CAVLC, the bench configuration included, tile-row slices, intra
refresh and loss-aware RDO), the legacy P16x16 path (``rd=False``), the
host-path encoder, rate control on both RD and host paths, the sequence
SEI, the decoder and the CLIs, and the sharded tile-row pipelines of
several ranks (``parallel/``: nccl with one card per rank, or gloo, on
the CPU or with ranks that share the cards; ROADMAP Queue 1).
"""

__version__ = "0.1.0"
