"""Random MPEG-4 Part 2 Simple Profile bitstreams, for holding a decoder
against FFmpeg's (cv2.VideoCapture) on the coding tools that cv2's own
encoder does not use: AC prediction, per-MB quantizer changes (dquant) and
the rescaled AC prediction across them, every intra_dc_vlc_thr (the DC as
its own VLC or among the AC codes), video packets (resync markers, with and
without the header extension), MPEG quantization with the default or a
loaded matrix, four motion vectors a macroblock, f_code 1-4, both rounding
types, MCBPC stuffing, and the three escapes.

Every syntax element is drawn from a seeded RandomState: the coefficient
levels, DC differentials and motion vector differences are random (not an
encoding of a picture), so both decoders must reconstruct the same samples
from prediction alone. Levels and differentials are kept small enough that
no sample arithmetic overflows 16 bits. The tables are the standard's
(ISO/IEC 14496-2 Annex B; the TCOEF tables as run and level counts).
"""

import numpy as np

INTRA_MCBPC = [(1, 1), (1, 3), (2, 3), (3, 3), (1, 4), (1, 6), (2, 6), (3, 6), (1, 9)]
INTER_MCBPC = [(1, 1), (3, 4), (2, 4), (5, 6), (3, 5), (4, 8), (3, 8), (3, 7), (3, 3), (7, 7), (6, 7),
 (5, 9), (4, 6), (4, 9), (3, 9), (2, 9), (2, 3), (5, 7), (4, 7), (5, 8), (1, 9), (0, 0),
 (0, 0), (0, 0), (2, 11), (12, 13), (14, 13), (15, 13)]
CBPY = [(3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4), (2, 5), (3, 6), (5, 4),
 (10, 4), (4, 4), (8, 4), (6, 4), (3, 2)]
MV = [(1, 1), (1, 2), (1, 3), (1, 4), (3, 6), (5, 7), (4, 7), (3, 7), (11, 9), (10, 9), (9, 9),
 (17, 10), (16, 10), (15, 10), (14, 10), (13, 10), (12, 10), (11, 10), (10, 10), (9, 10),
 (8, 10), (7, 10), (6, 10), (5, 10), (4, 10), (7, 11), (6, 11), (5, 11), (4, 11), (3, 11),
 (2, 11), (3, 12), (2, 12)]
DC_LUM = [(3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9),
 (1, 10), (1, 11)]
DC_CHROM = [(3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6), (1, 7), (1, 8), (1, 9), (1, 10),
 (1, 11), (1, 12)]
INTER_VLC = [(2, 2), (15, 4), (21, 6), (23, 7), (31, 8), (37, 9), (36, 9), (33, 10), (32, 10), (7, 11),
 (6, 11), (32, 11), (6, 3), (20, 6), (30, 8), (15, 10), (33, 11), (80, 12), (14, 4),
 (29, 8), (14, 10), (81, 12), (13, 5), (35, 9), (13, 10), (12, 5), (34, 9), (82, 12),
 (11, 5), (12, 10), (83, 12), (19, 6), (11, 10), (84, 12), (18, 6), (10, 10), (17, 6),
 (9, 10), (16, 6), (8, 10), (22, 7), (85, 12), (21, 7), (20, 7), (28, 8), (27, 8), (33, 9),
 (32, 9), (31, 9), (30, 9), (29, 9), (28, 9), (27, 9), (26, 9), (34, 11), (35, 11),
 (86, 12), (87, 12), (7, 4), (25, 9), (5, 11), (15, 6), (4, 11), (14, 6), (13, 6), (12, 6),
 (19, 7), (18, 7), (17, 7), (16, 7), (26, 8), (25, 8), (24, 8), (23, 8), (22, 8), (21, 8),
 (20, 8), (19, 8), (24, 9), (23, 9), (22, 9), (21, 9), (20, 9), (19, 9), (18, 9), (17, 9),
 (7, 10), (6, 10), (5, 10), (4, 10), (36, 11), (37, 11), (38, 11), (39, 11), (88, 12),
 (89, 12), (90, 12), (91, 12), (92, 12), (93, 12), (94, 12), (95, 12), (3, 7)]
INTRA_VLC = [(2, 2), (6, 3), (15, 4), (13, 5), (12, 5), (21, 6), (19, 6), (18, 6), (23, 7), (31, 8),
 (30, 8), (29, 8), (37, 9), (36, 9), (35, 9), (33, 9), (33, 10), (32, 10), (15, 10),
 (14, 10), (7, 11), (6, 11), (32, 11), (33, 11), (80, 12), (81, 12), (82, 12), (14, 4),
 (20, 6), (22, 7), (28, 8), (32, 9), (31, 9), (13, 10), (34, 11), (83, 12), (85, 12),
 (11, 5), (21, 7), (30, 9), (12, 10), (86, 12), (17, 6), (27, 8), (29, 9), (11, 10),
 (16, 6), (34, 9), (10, 10), (13, 6), (28, 9), (8, 10), (18, 7), (27, 9), (84, 12), (20, 7),
 (26, 9), (87, 12), (25, 8), (9, 10), (24, 8), (35, 11), (23, 8), (25, 9), (24, 9), (7, 10),
 (88, 12), (7, 4), (12, 6), (22, 8), (23, 9), (6, 10), (5, 11), (4, 11), (89, 12), (15, 6),
 (22, 9), (5, 10), (14, 6), (4, 10), (17, 7), (36, 11), (16, 7), (37, 11), (19, 7),
 (90, 12), (21, 8), (91, 12), (20, 8), (19, 8), (26, 8), (21, 9), (20, 9), (19, 9), (18, 9),
 (17, 9), (38, 11), (39, 11), (92, 12), (93, 12), (94, 12), (95, 12), (3, 7)]


def _run_level(per_run_last0, per_run_last1):
    """(run, level, last) of each TCOEF index, from the level counts per run."""
    out = []
    for last, counts in ((0, per_run_last0), (1, per_run_last1)):
        for run, n in enumerate(counts):
            out += [(run, level, last) for level in range(1, n + 1)]
    return out


INTRA_RLL = _run_level([27, 10, 5, 4, 3, 3, 3, 3, 2, 2, 1, 1, 1, 1, 1],
                       [8, 3, 2, 2, 2, 2, 2] + [1] * 14)
INTER_RLL = _run_level([12, 6, 4, 3, 3, 3, 3, 2, 2, 2, 2] + [1] * 16, [3, 2] + [1] * 39)
DC_THRESHOLD = [99, 13, 15, 17, 19, 21, 23, 0]
DEFAULT_RES = 30


class Tcoef:
    def __init__(self, vlc, rll):
        self.vlc, self.index = vlc, {t: i for i, t in enumerate(rll)}
        self.max_level = {}
        self.max_run = {}
        for run, level, last in rll:
            self.max_level[last, run] = max(self.max_level.get((last, run), 0), level)
            self.max_run[last, level] = max(self.max_run.get((last, level), 0), run)


INTRA = Tcoef(INTRA_VLC, INTRA_RLL)
INTER = Tcoef(INTER_VLC, INTER_RLL)


class Bits:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int):
        self.bits += [(value >> (n - 1 - i)) & 1 for i in range(n)]

    def code(self, pair):
        self.put(*pair)

    def stuff(self):
        """next_start_code() / next_resync_marker(): a 0, then 1s to the byte."""
        self.put(0, 1)
        while len(self.bits) % 8:
            self.put(1, 1)

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0
        b = np.packbits(np.array(self.bits, np.uint8))
        return b.tobytes()


def vol(w: int, h: int, quant_type: int = 0, matrices=(None, None), resync: bool = False,
        res: int = DEFAULT_RES) -> bytes:
    """VOS, VO and VOL headers (Simple Profile, 4:2:0, rectangular)."""
    b = Bits()
    for byte in (0, 0, 1, 0xB0, 0x01, 0, 0, 1, 0xB5, 0x09, 0, 0, 1, 0x00, 0, 0, 1, 0x20):
        b.put(byte, 8)
    b.put(0, 1); b.put(1, 8); b.put(1, 1); b.put(1, 4); b.put(1, 3); b.put(1, 4)
    b.put(1, 1); b.put(1, 2); b.put(1, 1); b.put(0, 1)
    b.put(0, 2); b.put(1, 1); b.put(res, 16); b.put(1, 1); b.put(0, 1)
    b.put(1, 1); b.put(w, 13); b.put(1, 1); b.put(h, 13); b.put(1, 1)
    b.put(0, 1); b.put(1, 1); b.put(0, 1); b.put(0, 1)
    b.put(quant_type, 1)
    if quant_type:
        for mat in matrices:                      # loaded in zigzag order, 0 ends
            b.put(mat is not None, 1)
            if mat is not None:
                for v in mat:
                    b.put(int(v), 8)
                if len(mat) < 64:
                    b.put(0, 8)
    b.put(1, 1); b.put(0 if resync else 1, 1); b.put(0, 1); b.put(0, 1)
    b.stuff()
    return b.bytes()


class StreamGen:
    """Random VOPs of one VOL (`vol(w, h, ...)` with the same arguments)."""

    # how often each tool is drawn (a test may turn one off to isolate it)
    ODDS = {"direct_code": 0.8, "ac_pred": 0.5, "dquant": 0.3, "stuffing": 0.05,
            "packet": 0.15, "hec": 0.5, "big_dc": 0.1, "skip": 0.15, "thr": 1.0,
            "inter4v": 0.25, "intra_in_p": 0.2, "coded": 0.5, "big_level": 0.25}

    def __init__(self, rng: np.random.RandomState, w: int, h: int, resync: bool = False,
                 res: int = DEFAULT_RES, **odds):
        self.rng, self.w, self.h, self.resync, self.res = rng, w, h, resync, res
        self.odds = dict(self.ODDS, **odds)
        self.mbw, self.mbh = (w + 15) // 16, (h + 15) // 16
        self.mb_num = self.mbw * self.mbh
        self.inc_bits = max(1, (res - 1).bit_length())
        self.n = self.secs = 0

    # ----------------------------------------------------------- elements
    def _tcoef(self, b: Bits, tab: Tcoef, run: int, level: int, last: int):
        """One (run, level, last), by its code or one of the three escapes."""
        r = self.rng
        a, sign = abs(level), int(level < 0)
        esc = tab.vlc[102]
        i = tab.index.get((run, a, last))
        if i is not None and r.rand() < self.odds["direct_code"]:
            b.code(tab.vlc[i]); b.put(sign, 1)
            return
        ml = tab.max_level.get((last, run), 0)
        i1 = tab.index.get((run, a - ml, last)) if ml else None
        mr = tab.max_run.get((last, a))
        i2 = tab.index.get((run - mr - 1, a, last)) if mr is not None else None
        mode = r.choice([m for m, ok in ((1, i1 is not None), (2, i2 is not None), (3, True))
                         if ok])
        b.code(esc)
        if mode == 1:
            b.put(0, 1); b.code(tab.vlc[i1]); b.put(sign, 1)
        elif mode == 2:
            b.put(2, 2); b.code(tab.vlc[i2]); b.put(sign, 1)
        else:
            b.put(3, 2); b.put(last, 1); b.put(run, 6); b.put(1, 1)
            b.put(level & 0xFFF, 12); b.put(1, 1)

    def _level(self):
        r = self.rng
        if r.rand() < self.odds["big_level"]:
            mag = r.randint(4, 14) if r.rand() < 0.8 else r.randint(14, 40)
        else:
            mag = r.randint(1, 4)
        return mag if r.rand() < 0.5 else -mag

    def _coefs(self, b: Bits, tab: Tcoef, first: int):
        """A random coded block from scan position `first` (0 or 1) on."""
        r = self.rng
        pos, n = first - 1, r.randint(1, 7)
        for k in range(n):
            room = 63 - pos - (n - 1 - k)
            run = min(int(r.geometric(0.35)) - 1, room - 1)
            pos += run + 1
            last = int(k == n - 1)
            self._tcoef(b, tab, run, self._level(), last)

    def _dc(self, b: Bits, luma: bool):
        r = self.rng
        # large differentials upwards only: a DC level below 0 is an error
        # to FFmpeg (it conceals the picture), and the prediction is >= 0
        diff = (int(r.randint(200, 301)) if r.rand() < self.odds["big_dc"]
                else int(r.randint(-3, 4)))
        size = abs(diff).bit_length()
        b.code((DC_LUM if luma else DC_CHROM)[size])
        if size:
            b.put(diff if diff > 0 else diff + (1 << size) - 1, size)
            if size > 8:
                b.put(1, 1)

    def _cbp(self, n: int) -> int:
        return sum(1 << k for k in range(n) if self.rng.rand() < self.odds["coded"])

    def _intra_mb(self, b: Bits, cbpc: int, dquant: bool):
        r = self.rng
        b.put(int(r.rand() < self.odds["ac_pred"]), 1)  # ac_pred_flag
        cbpy = self._cbp(4)
        b.code(CBPY[cbpy])
        use_dc_vlc = self.q < self.dc_thr               # the quantizer before dquant
        if dquant:
            d = r.randint(4)
            b.put(d, 2)
            self.q = min(31, max(1, self.q + (-1, -2, 1, 2)[d]))
        cbp = cbpc | (cbpy << 2)
        for n in range(6):
            if use_dc_vlc:
                self._dc(b, n < 4)
            if cbp & (32 >> n):
                self._coefs(b, INTRA, 1 if use_dc_vlc else 0)

    def _mvd(self, b: Bits):
        r = self.rng
        code = 0 if r.rand() < 0.2 else int(min(32, r.geometric(0.3)))
        b.code(MV[code])
        if code:
            b.put(int(r.rand() < 0.5), 1)
            shift = self.f_code - 1
            if shift:
                b.put(r.randint(1 << shift), shift)

    def _inter_mb(self, b: Bits, kind: str, cbpc: int, dquant: bool):
        r = self.rng
        cbpy = self._cbp(4)
        b.code(CBPY[cbpy ^ 0xF])
        if dquant:
            d = r.randint(4)
            b.put(d, 2)
            self.q = min(31, max(1, self.q + (-1, -2, 1, 2)[d]))
        for _ in range(4 if kind == "inter4v" else 1):
            self._mvd(b); self._mvd(b)
        cbp = cbpc | (cbpy << 2)
        for n in range(6):
            if cbp & (32 >> n):
                self._coefs(b, INTER, 0)

    def _packet_header(self, b: Bits, mb: int, p: bool):
        """Stuffing, a resync marker and a video packet header before MB `mb`."""
        r = self.rng
        b.stuff()
        b.put(0, 16 if not p else self.f_code + 15)
        b.put(1, 1)
        b.put(mb, max(1, (self.mb_num - 1).bit_length()))
        self.q = int(r.randint(1, 32))
        b.put(self.q, 5)
        hec = int(r.rand() < self.odds["hec"])
        b.put(hec, 1)
        if hec:
            b.put(0, 1); b.put(1, 1); b.put(0, self.inc_bits); b.put(1, 1)
            b.put(int(p), 2); b.put(self.thr_code, 3)
            if p:
                b.put(self.f_code, 3)

    # ---------------------------------------------------------------- VOPs
    def vop(self, p: bool) -> bytes:
        """One random I-VOP (p False) or P-VOP."""
        r = self.rng
        b = Bits()
        for byte in (0, 0, 1, 0xB6):
            b.put(byte, 8)
        b.put(int(p), 2)
        secs, inc = divmod(self.n, self.res)          # one tick a frame
        for _ in range(secs - self.secs):              # modulo_time_base
            b.put(1, 1)
        b.put(0, 1)
        self.secs = secs
        b.put(1, 1); b.put(inc, self.inc_bits); b.put(1, 1); b.put(1, 1)
        if p:
            b.put(int(r.rand() < 0.5), 1)               # vop_rounding_type
        self.thr_code = int(r.randint(8)) if r.rand() < self.odds["thr"] else 0
        self.dc_thr = DC_THRESHOLD[self.thr_code]
        b.put(self.thr_code, 3)
        self.q = int(r.randint(1, 32))
        b.put(self.q, 5)
        if p:
            self.f_code = int(r.randint(1, 5))
            b.put(self.f_code, 3)
        for mb in range(self.mb_num):
            if mb and self.resync and r.rand() < self.odds["packet"]:
                self._packet_header(b, mb, p)
            if r.rand() < self.odds["stuffing"]:       # MCBPC stuffing
                if p:
                    b.put(0, 1); b.code(INTER_MCBPC[20])
                else:
                    b.code(INTRA_MCBPC[8])
            if not p:
                dq = r.rand() < self.odds["dquant"]
                cbpc = self._cbp(2)
                b.code(INTRA_MCBPC[cbpc + 4 * dq])
                self._intra_mb(b, cbpc, dq)
                continue
            if r.rand() < self.odds["skip"]:
                b.put(1, 1)                            # not coded
                continue
            b.put(0, 1)
            u = r.rand()
            kind = ("intra" if u < self.odds["intra_in_p"] else
                    "inter4v" if u < self.odds["intra_in_p"] + self.odds["inter4v"] else "inter")
            dq = r.rand() < self.odds["dquant"]
            cbpc = self._cbp(2)
            base = {"inter": 8 if dq else 0, "inter4v": 16, "intra": 12 if dq else 4}[kind]
            dq = dq and kind != "inter4v"
            b.code(INTER_MCBPC[base + cbpc])
            if kind == "intra":
                self._intra_mb(b, cbpc, dq)
            else:
                self._inter_mb(b, kind, cbpc, dq)
        b.stuff()
        self.n += 1
        return b.bytes()
