"""Decoded picture buffer and reference list construction (spec §8.2.4/5).

Host-side bookkeeping (the JM mbuffer.c role): sliding-window and
adaptive (MMCO) marking, long-term frames, pic_num derivation, P/B
default list ordering, and ref-list modification. Reference behavior:
ldecod/src/mbuffer.c (store_picture_in_dpb :2336, adaptive marking
:1678+, init_lists :1011).
"""

from __future__ import annotations

import numpy as np

from ..syntax.slice_header import RefPicListMod, SliceHeader, SliceType


class DPB:
    def __init__(self, sps):
        self.sps = sps
        self.pics: list = []  # DecodedPicture, decode order
        self.max_refs = max(1, sps.num_ref_frames)
        self.max_long_term_idx = -1  # MaxLongTermFrameIdx ("no long-term")

    def idr_flush(self):
        self.pics.clear()
        self.max_long_term_idx = -1

    # -- marking (spec §8.2.5) ---------------------------------------------
    def store(self, pic, sh: SliceHeader | None = None) -> bool:
        """Mark references and store; returns True if MMCO5 was executed."""
        mmco5 = False
        if pic.is_ref:
            if sh is not None and sh.adaptive_ref_pic_marking_mode_flag:
                mmco5 = self._adaptive_marking(pic, sh)
            elif not pic.long_term:
                self._sliding_window()
        self.pics.append(pic)
        return mmco5

    def _sliding_window(self):
        st_refs = [p for p in self.pics if p.is_ref and not p.long_term]
        lt_refs = [p for p in self.pics if p.is_ref and p.long_term]
        if len(st_refs) + len(lt_refs) >= self.max_refs and st_refs:
            oldest = min(st_refs, key=lambda p: p.frame_num_wrap)
            oldest.is_ref = False

    def _adaptive_marking(self, pic, sh: SliceHeader) -> bool:
        """memory_management_control_operations (spec §8.2.5.4,
        ldecod/src/mbuffer.c:1678+ mm_* functions)."""
        mmco5 = False
        curr_pic_num = sh.frame_num
        for m in sh.mmco_ops:
            if m.op == 1:  # unmark short-term
                pic_num_x = curr_pic_num - (m.value1 + 1)
                for p in self.short_term_refs():
                    if p.pic_num == pic_num_x:
                        p.is_ref = False
            elif m.op == 2:  # unmark long-term by long_term_pic_num
                for p in self.long_term_refs():
                    if p.long_term_idx == m.value1:
                        p.is_ref = False
                        p.long_term = False
            elif m.op == 3:  # short-term -> long-term
                pic_num_x = curr_pic_num - (m.value1 + 1)
                for p in self.long_term_refs():
                    if p.long_term_idx == m.value2:
                        p.is_ref = False
                        p.long_term = False
                for p in self.short_term_refs():
                    if p.pic_num == pic_num_x:
                        p.long_term = True
                        p.long_term_idx = m.value2
            elif m.op == 4:  # set MaxLongTermFrameIdx
                self.max_long_term_idx = m.value1 - 1
                for p in self.long_term_refs():
                    if p.long_term_idx > self.max_long_term_idx:
                        p.is_ref = False
                        p.long_term = False
            elif m.op == 5:  # unmark everything, reset
                for p in self.pics:
                    p.is_ref = False
                    p.long_term = False
                self.max_long_term_idx = -1
                mmco5 = True
            elif m.op == 6:  # current picture -> long-term
                for p in self.long_term_refs():
                    if p.long_term_idx == m.value2:
                        p.is_ref = False
                        p.long_term = False
                pic.long_term = True
                pic.long_term_idx = m.value2
        return mmco5

    def short_term_refs(self):
        return [p for p in self.pics if p.is_ref and not p.long_term]

    def long_term_refs(self):
        return [p for p in self.pics if p.is_ref and p.long_term]

    def update_pic_nums(self, frame_num: int, max_frame_num: int):
        for p in self.pics:
            if p.frame_num > frame_num:
                p.frame_num_wrap = p.frame_num - max_frame_num
            else:
                p.frame_num_wrap = p.frame_num
            # frames: PicNum = FrameNumWrap, LongTermPicNum = LongTermFrameIdx
            p.pic_num = p.long_term_idx if p.long_term else p.frame_num_wrap

    def build_lists(self, sh: SliceHeader, cur_poc: int):
        """Default RefPicList0/1 (frames) + slice-header modification."""
        refs = self.short_term_refs()
        lt = sorted(self.long_term_refs(), key=lambda p: p.long_term_idx)
        if sh.slice_type in (SliceType.P, SliceType.SP):
            l0 = sorted(refs, key=lambda p: -p.pic_num) + lt
            lists = [l0, []]
        elif sh.slice_type == SliceType.B:
            before = sorted([p for p in refs if p.poc < cur_poc], key=lambda p: -p.poc)
            after = sorted([p for p in refs if p.poc > cur_poc], key=lambda p: p.poc)
            l0 = before + after + lt
            l1 = after + before + lt
            if len(l0) > 1 and l0 == l1:
                l1 = [l1[1], l1[0]] + l1[2:]
            lists = [l0, l1]
        else:
            return [[], []]
        # apply modifications
        max_fn = self.sps.max_frame_num
        num_active = (
            sh.num_ref_idx_l0_active_minus1 + 1,
            sh.num_ref_idx_l1_active_minus1 + 1,
        )
        out = []
        for lst in (0, 1):
            base = lists[lst]
            mods = sh.ref_pic_list_mods[lst]
            if mods:
                base = self._modify(base, mods, sh, max_fn, num_active[lst])
            out.append(base[: num_active[lst]] if base else base)
        return out

    def _modify(self, init_list, mods: list[RefPicListMod], sh, max_fn, num_active):
        """Spec §8.2.4.3 short/long-term reordering."""
        lst = list(init_list)
        pic_num_pred = sh.frame_num
        refIdxLX = 0
        for m in mods:
            if m.modification_of_pic_nums_idc in (0, 1):
                abs_diff = m.value + 1
                if m.modification_of_pic_nums_idc == 0:
                    pic_num_no_wrap = pic_num_pred - abs_diff
                    if pic_num_no_wrap < 0:
                        pic_num_no_wrap += max_fn
                else:
                    pic_num_no_wrap = pic_num_pred + abs_diff
                    if pic_num_no_wrap >= max_fn:
                        pic_num_no_wrap -= max_fn
                pic_num_pred = pic_num_no_wrap
                pic_num = pic_num_no_wrap
                if pic_num > sh.frame_num:
                    pic_num -= max_fn
                target = next(
                    (p for p in self.short_term_refs() if p.pic_num == pic_num), None
                )
                if target is None:
                    raise ValueError(f"reorder: no short-term pic_num {pic_num}")
            elif m.modification_of_pic_nums_idc == 2:
                target = next(
                    (
                        p
                        for p in self.pics
                        if p.is_ref and p.long_term and p.long_term_idx == m.value
                    ),
                    None,
                )
                if target is None:
                    raise ValueError("reorder: no long-term pic")
            else:
                raise ValueError("bad modification idc")
            # insert at refIdxLX, drop the later duplicate (spec 8-38/8-39)
            lst.insert(refIdxLX, target)
            for i in range(refIdxLX + 1, len(lst)):
                if lst[i] is target:
                    del lst[i]
                    break
            refIdxLX += 1
        return lst

    def output_order(self):
        return sorted(self.pics, key=lambda p: p.poc)
