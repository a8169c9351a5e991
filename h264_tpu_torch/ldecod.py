"""ldecod of the port: JM-compatible decoder CLI.

Usage (ldecod.exe-compatible, ldecod/src/ldecod.c:508 init_conf):
    python -m h264_tpu_torch.ldecod [--device DEV] decoder.cfg
    python -m h264_tpu_torch.ldecod [--device DEV] stream.264 out.yuv [ref.yuv]

Decodes Annex-B or JM RTP packet files, writes display-order YUV, and
reports per-frame POC/type plus PSNR against a reference file if given.
The inter reconstruction runs on the CUDA card (K8) unless ``--device``
names another (``--device cpu``: its plain PyTorch version).
"""

from __future__ import annotations

import sys

import numpy as np

from .bitstream.nal import NalUnit
from .bitstream.rtp import read_rtp
from .config import DecoderRunConfig, parse_decoder_cfg
from .decoder.decoder import H264Decoder
from .io import frame_size, psnr, write_yuv_frame


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    device = None
    if "--device" in args:
        i = args.index("--device")
        device = args[i + 1] if i + 1 < len(args) else None
        del args[i: i + 2]
    if not args:
        print(__doc__)
        return 1
    if len(args) == 1 and args[0].endswith(".cfg"):
        run = parse_decoder_cfg(args[0])
    else:
        run = DecoderRunConfig(input_file=args[0])
        if len(args) > 1:
            run.output_file = args[1]
        if len(args) > 2:
            run.ref_file = args[2]
        if args[0].endswith((".rtp", ".264r")):
            run.nal_mode = 1
    data = open(run.input_file, "rb").read()
    dec = H264Decoder(conceal_mode=run.concealment_mode, use_device=True,
                      device=device)
    if run.nal_mode == 1:
        pics = list(dec.decode_nalus(read_rtp(data)))
    else:
        pics = list(dec.decode_stream(data))
    # display order: POC within each IDR segment
    groups: list[list] = [[]]
    for p in pics:
        if p.poc == 0 and groups[-1]:
            groups.append([])
        groups[-1].append(p)
    ordered = [p for g in groups for p in sorted(g, key=lambda q: q.poc)]
    ref = None
    if run.ref_file:
        try:
            ref = open(run.ref_file, "rb").read()
        except OSError:
            ref = None
    with open(run.output_file, "wb") as f:
        for i, p in enumerate(ordered):
            write_yuv_frame(f, p.planes)
            line = f"{i:5d}  POC {p.poc:4d}  {p.slice_type.name}"
            if ref is not None:
                W = np.asarray(p.planes.Y).shape[1]
                H = np.asarray(p.planes.Y).shape[0]
                fs = frame_size(W, H)
                off = i * fs
                if off + fs <= len(ref):
                    rY = np.frombuffer(ref, np.uint8, W * H, off).reshape(H, W)
                    line += f"  SnrY {psnr(p.planes.Y, rY):7.3f}"
            if not run.silent:
                print(line)
    if not run.silent:
        print(f" {len(ordered)} frames -> {run.output_file}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
