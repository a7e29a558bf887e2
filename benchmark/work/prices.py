"""What one operation of the counts costs, in 32-bit integer multiplies.

A product modulo a 254-bit prime (Fr or Fq) on 32-bit words is a Montgomery
product of 8 words: 64 word products for the schoolbook product and 64 for
the reduction, each 32 x 32 -> 64 bits and so two multiply instructions (the
low and the high half), and 8 low halves for the reduction's quotients:
2 * 128 + 8 = 264.

A point addition is priced at the cheapest known formula: an affine addition
under a batched inversion (Montgomery's trick shares one inversion among
many additions for 3 products each): lambda = (y2 - y1) / (x2 - x1) is the
batch's 3 products and 1, x3 = lambda^2 - x1 - x2 one squaring, y3 =
lambda (x1 - x3) - y1 one product: 6 Fq products on G1. On G2 each of them
is an Fq2 product of 3 Fq products (Karatsuba), the squaring 2: 17."""

FIELD_MUL = 264
G1_ADD = 6 * FIELD_MUL
G2_ADD = 17 * FIELD_MUL
ELEMENT_BYTES = 32
G1_AFFINE_BYTES = 64
G2_AFFINE_BYTES = 128
