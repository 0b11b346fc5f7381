"""TS 38.212 polar construction, written out plainly from the spec.

* ``RELIABILITY``: Table 5.3.1.2-1, bit-channel indices in ascending
  reliability (a frozen copy of the table).
* ``ranked_code``: the k most reliable of the n lowest indices (5.3.1.2).
* ``UciCode``: a 5G uplink control code of A payload bits sent in E bits:
  CRC6 (5.1), the mother-code size (5.3.1), the info set with its
  PC bits (5.3.1.2), sub-block interleaving (5.4.1.1), bit selection by
  repetition (5.4.1.2) and the channel interleaver (5.4.1.3). Only
  repetition (E >= N) is written out.

Nothing here imports the program under test.
"""

import numpy as np

RELIABILITY = np.array([
    0, 1, 2, 4, 8, 16, 32, 3, 5, 64, 9, 6, 17, 10, 18, 128,
    12, 33, 65, 20, 256, 34, 24, 36, 7, 129, 66, 512, 11, 40, 68, 130,
    19, 13, 48, 14, 72, 257, 21, 132, 35, 258, 26, 513, 80, 37, 25, 22,
    136, 260, 264, 38, 514, 96, 67, 41, 144, 28, 69, 42, 516, 49, 74, 272,
    160, 520, 288, 528, 192, 544, 70, 44, 131, 81, 50, 73, 15, 320, 133, 52,
    23, 134, 384, 76, 137, 82, 56, 27, 97, 39, 259, 84, 138, 145, 261, 29,
    43, 98, 515, 88, 140, 30, 146, 71, 262, 265, 161, 576, 45, 100, 640, 51,
    148, 46, 75, 266, 273, 517, 104, 162, 53, 193, 152, 77, 164, 768, 268, 274,
    518, 54, 83, 57, 521, 112, 135, 78, 289, 194, 85, 276, 522, 58, 168, 139,
    99, 86, 60, 280, 89, 290, 529, 524, 196, 141, 101, 147, 176, 142, 530, 321,
    31, 200, 90, 545, 292, 322, 532, 263, 149, 102, 105, 304, 296, 163, 92, 47,
    267, 385, 546, 324, 208, 386, 150, 153, 165, 106, 55, 328, 536, 577, 548, 113,
    154, 79, 269, 108, 578, 224, 166, 519, 552, 195, 270, 641, 523, 275, 580, 291,
    59, 169, 560, 114, 277, 156, 87, 197, 116, 170, 61, 531, 525, 642, 281, 278,
    526, 177, 293, 388, 91, 584, 769, 198, 172, 120, 201, 336, 62, 282, 143, 103,
    178, 294, 93, 644, 202, 592, 323, 392, 297, 770, 107, 180, 151, 209, 284, 648,
    94, 204, 298, 400, 608, 352, 325, 533, 155, 210, 305, 547, 300, 109, 184, 534,
    537, 115, 167, 225, 326, 306, 772, 157, 656, 329, 110, 117, 212, 171, 776, 330,
    226, 549, 538, 387, 308, 216, 416, 271, 279, 158, 337, 550, 672, 118, 332, 579,
    540, 389, 173, 121, 553, 199, 784, 179, 228, 338, 312, 704, 390, 174, 554, 581,
    393, 283, 122, 448, 353, 561, 203, 63, 340, 394, 527, 582, 556, 181, 295, 285,
    232, 124, 205, 182, 643, 562, 286, 585, 299, 354, 211, 401, 185, 396, 344, 586,
    645, 593, 535, 240, 206, 95, 327, 564, 800, 402, 356, 307, 301, 417, 213, 568,
    832, 588, 186, 646, 404, 227, 896, 594, 418, 302, 649, 771, 360, 539, 111, 331,
    214, 309, 188, 449, 217, 408, 609, 596, 551, 650, 229, 159, 420, 310, 541, 773,
    610, 657, 333, 119, 600, 339, 218, 368, 652, 230, 391, 313, 450, 542, 334, 233,
    555, 774, 175, 123, 658, 612, 341, 777, 220, 314, 424, 395, 673, 583, 355, 287,
    183, 234, 125, 557, 660, 616, 342, 316, 241, 778, 563, 345, 452, 397, 403, 207,
    674, 558, 785, 432, 357, 187, 236, 664, 624, 587, 780, 705, 126, 242, 565, 398,
    346, 456, 358, 405, 303, 569, 244, 595, 189, 566, 676, 361, 706, 589, 215, 786,
    647, 348, 419, 406, 464, 680, 801, 362, 590, 409, 570, 788, 597, 572, 219, 311,
    708, 598, 601, 651, 421, 792, 802, 611, 602, 410, 231, 688, 653, 248, 369, 190,
    364, 654, 659, 335, 480, 315, 221, 370, 613, 422, 425, 451, 614, 543, 235, 412,
    343, 372, 775, 317, 222, 426, 453, 237, 559, 833, 804, 712, 834, 661, 808, 779,
    617, 604, 433, 720, 816, 836, 347, 897, 243, 662, 454, 318, 675, 618, 898, 781,
    376, 428, 665, 736, 567, 840, 625, 238, 359, 457, 399, 787, 591, 678, 434, 677,
    349, 245, 458, 666, 620, 363, 127, 191, 782, 407, 436, 626, 571, 465, 681, 246,
    707, 350, 599, 668, 790, 460, 249, 682, 573, 411, 803, 789, 709, 365, 440, 628,
    689, 374, 423, 466, 793, 250, 371, 481, 574, 413, 603, 366, 468, 655, 900, 805,
    615, 684, 710, 429, 794, 252, 373, 605, 848, 690, 713, 632, 482, 806, 427, 904,
    414, 223, 663, 692, 835, 619, 472, 455, 796, 809, 714, 721, 837, 716, 864, 810,
    606, 912, 722, 696, 377, 435, 817, 319, 621, 812, 484, 430, 838, 667, 488, 239,
    378, 459, 622, 627, 437, 380, 818, 461, 496, 669, 679, 724, 841, 629, 351, 467,
    438, 737, 251, 462, 442, 441, 469, 247, 683, 842, 738, 899, 670, 783, 849, 820,
    728, 928, 791, 367, 901, 630, 685, 844, 633, 711, 253, 691, 824, 902, 686, 740,
    850, 375, 444, 470, 483, 415, 485, 905, 795, 473, 634, 744, 852, 960, 865, 693,
    797, 906, 715, 807, 474, 636, 694, 254, 717, 575, 913, 798, 811, 379, 697, 431,
    607, 489, 866, 723, 486, 908, 718, 813, 476, 856, 839, 725, 698, 914, 752, 868,
    819, 814, 439, 929, 490, 623, 671, 739, 916, 463, 843, 381, 497, 930, 821, 726,
    961, 872, 492, 631, 729, 700, 443, 741, 845, 920, 382, 822, 851, 730, 498, 880,
    742, 445, 471, 635, 932, 687, 903, 825, 500, 846, 745, 826, 732, 446, 962, 936,
    475, 853, 867, 637, 907, 487, 695, 746, 828, 753, 854, 857, 504, 799, 255, 964,
    909, 719, 477, 915, 638, 748, 944, 869, 491, 699, 754, 858, 478, 968, 383, 910,
    815, 976, 870, 917, 727, 493, 873, 701, 931, 756, 860, 499, 731, 823, 922, 874,
    918, 502, 933, 743, 760, 881, 494, 702, 921, 501, 876, 847, 992, 447, 733, 827,
    934, 882, 937, 963, 747, 505, 855, 924, 734, 829, 965, 938, 884, 506, 749, 945,
    966, 755, 859, 940, 830, 911, 871, 639, 888, 479, 946, 750, 969, 508, 861, 757,
    970, 919, 875, 862, 758, 948, 977, 923, 972, 761, 877, 952, 495, 703, 935, 978,
    883, 762, 503, 925, 878, 735, 993, 885, 939, 994, 980, 926, 764, 941, 967, 886,
    831, 947, 507, 889, 984, 751, 942, 996, 971, 890, 509, 949, 973, 1000, 892, 950,
    863, 759, 1008, 510, 979, 953, 763, 974, 954, 879, 981, 982, 927, 995, 765, 956,
    887, 985, 997, 986, 943, 891, 998, 766, 511, 988, 1001, 951, 1002, 893, 975, 894,
    1009, 955, 1004, 1010, 957, 983, 958, 987, 1012, 999, 1016, 767, 989, 1003, 990, 1005,
    959, 1011, 1013, 895, 1006, 1014, 1017, 1018, 991, 1020, 1007, 1015, 1019, 1021, 1022, 1023,
], dtype=np.int64)

# Table 5.4.1.1-1: the sub-block interleaver pattern P(i)
SUBBLOCK_PATTERN = [0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
                    12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29,
                    30, 31]

# 5.1: generator polynomials as the exponents of their nonzero terms
CRC_POLY = {"CRC6": (6, 5, 0)}

PC_BITS = 3          # 5.3.1.2: n_PC for 12 <= A <= 19
PC_REGISTER = 5      # 5.3.1.2: the cyclic shift register y0..y4


def ranked_code(k, n):
    """(info positions ascending, frozen mask [n] bool) of the 5G-ranked
    (n, k) code: the k most reliable of the indices below n."""
    q = RELIABILITY[RELIABILITY < n]
    info = np.sort(q[n - k:])
    frozen = np.ones(n, dtype=bool)
    frozen[info] = False
    return info, frozen


def crc_parity(bits, crc):
    """CRC parity bits [..., L] of ``bits`` [..., A] (0/1 integers): the
    remainder of a(D) D^L divided by g(D), first bit highest, by long
    division one bit at a time."""
    exps = CRC_POLY[crc]
    L = exps[0]
    g = np.zeros(L, dtype=np.int64)       # the terms below D^L, D^(L-1) first
    for e in exps[1:]:
        g[L - 1 - e] = 1
    bits = np.asarray(bits, dtype=np.int64)
    reg = np.zeros(bits.shape[:-1] + (L,), dtype=np.int64)
    for i in range(bits.shape[-1]):
        fb = reg[..., 0] ^ bits[..., i]
        reg = np.concatenate([reg[..., 1:], np.zeros_like(reg[..., :1])],
                             axis=-1)
        reg ^= fb[..., None] * g
    return reg


def subblock_index(n):
    """J(k) of 5.4.1.1: y_k = d_J(k)."""
    k = np.arange(n)
    i = (32 * k) // n
    return np.array(SUBBLOCK_PATTERN)[i] * (n // 32) + k % (n // 32)


def channel_interleaver_index(e):
    """The read order of 5.4.1.3: f_t = e_idx[t]. The E bits are written
    row by row into the upper-left triangle of a T x T array (T the least
    with T(T+1)/2 >= E, NULL past E) and read column by column."""
    t = 0
    while t * (t + 1) // 2 < e:
        t += 1
    v = -np.ones((t, t), dtype=np.int64)
    k = 0
    for i in range(t):
        for j in range(t - i):
            if k < e:
                v[i, j] = k
            k += 1
    out = [v[i, j] for j in range(t) for i in range(t - j) if v[i, j] >= 0]
    return np.array(out, dtype=np.int64)


class UciCode:
    """The uplink control code of ``a`` payload bits in ``e`` coded bits,
    built from TS 38.212 alone. Attributes: ``crc``, ``k`` (payload and
    CRC), ``n`` (mother code), ``info`` (info positions with the PC ones,
    ascending), ``pc`` (PC positions), ``frozen`` [n] bool, ``pc_mask``
    [n] bool, ``rm`` [e]: coded bit t is bit ``rm[t]`` of the mother
    codeword d."""

    def __init__(self, a, e):
        if not 12 <= a <= 19:
            raise ValueError("this reference covers 12 <= A <= 19 (CRC6 "
                             "and PC bits)")
        self.a, self.e = a, e
        self.crc = "CRC6"
        self.k = a + 6
        k_pc = self.k + PC_BITS
        # 5.3.1: mother code size, n_min = 5, n_max = 10 (uplink)
        ce = int(np.ceil(np.log2(e)))
        if e <= (9 / 8) * 2 ** (ce - 1) and self.k / e < 9 / 16:
            n1 = ce - 1
        else:
            n1 = ce
        n2 = int(np.ceil(np.log2(self.k / (1 / 8))))
        self.n = 1 << max(min(n1, n2, 10), 5)
        if e < self.n:
            raise NotImplementedError("only repetition (E >= N) is written "
                                      "out")
        q = RELIABILITY[RELIABILITY < self.n]        # no pre-frozen bits
        q_i = q[self.n - k_pc:]                      # ascending reliability
        n_wm = 1 if e - self.k + 3 > 192 else 0
        pc = list(q_i[:PC_BITS - n_wm])              # the least reliable
        if n_wm:
            rest = q_i[PC_BITS - n_wm:]              # Q~_I: K + n_wm of them
            w = np.array([bin(int(i)).count("1") for i in rest])
            cand = rest[w == w.min()]
            pc.append(int(cand[-1]))                 # the most reliable
        self.info = np.sort(q_i)
        self.pc = np.sort(np.array(pc, dtype=np.int64))
        self.frozen = np.ones(self.n, dtype=bool)
        self.frozen[self.info] = False
        self.pc_mask = np.zeros(self.n, dtype=bool)
        self.pc_mask[self.pc] = True
        # 5.4.1: sub-block interleave, repeat, channel interleave
        j = subblock_index(self.n)
        self.rm = j[channel_interleaver_index(e) % self.n]

    def u_vector(self, c):
        """The mother code's input u [..., n] of payload-and-CRC words c
        [..., k] (0/1 integers), by the loop of 5.3.1.2."""
        c = np.asarray(c, dtype=np.int64)
        u = np.zeros(c.shape[:-1] + (self.n,), dtype=np.int64)
        y = np.zeros((PC_REGISTER,) + c.shape[:-1], dtype=np.int64)
        kk = 0
        for pos in range(self.n):
            y = np.roll(y, -1, axis=0)               # y0 <- y1, ..., y4 <- y0
            if self.frozen[pos]:
                continue
            if self.pc_mask[pos]:
                u[..., pos] = y[0]
            else:
                u[..., pos] = c[..., kk]
                kk += 1
                y[0] ^= u[..., pos]
        return u
