"""The composite frame's work outside kernel B, in float32 operations
counted from shapes (a multiply-add is two):

- compose, for every slot composed (the background's and each actor's,
  inactive slots and actors not alive included: the port computes them
  all): the view direction (12: subtract, square-sum, rsqrt, scale), the
  SH basis (degree 1: 3, 2: 15 more, 3: 35 more), the colour sum
  (6 a coefficient), + 0.5 and the clamp (6), the opacity's sigmoid (4),
  the scales' exp (3), the rotation's normalisation (11);
- for each actor slot besides: the Fourier DC sum (6 a coefficient), the
  quaternion product with the actor's world rotation (28) and its
  normalisation (11), the mean's rotation and translation (18);
- the sky, a pixel: the ray (K^-1 and the rotation, 30; normalisation,
  12), the face and its coordinates (12), four texel taps blended (29),
  the clamp (6), the composite rgb + sky (1 - alpha) and its clamp (15).
"""

SH_BASIS = (0, 3, 18, 53)
SLOT = 12 + 6 + 4 + 3 + 11
ACTOR_SLOT = 28 + 11 + 18
SKY_PIXEL = 30 + 12 + 12 + 29 + 6 + 15


def compose_flops(cfg: dict, slots: float, actor_slots: float) -> float:
    g = cfg["config"]["model"]["gaussian"]
    deg = g["sh_degree"]
    per = SLOT + SH_BASIS[deg] + 6 * (deg + 1) ** 2
    return float(per * slots
                 + (ACTOR_SLOT + 6 * g["fourier_dim"]) * actor_slots)


def sky_flops(cfg: dict) -> float:
    if not cfg["config"]["model"]["nsg"]["include_sky"]:
        return 0.0
    sc = cfg["scene"]
    return float(SKY_PIXEL * sc["width"] * sc["height"])
