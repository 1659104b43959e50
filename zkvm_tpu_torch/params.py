"""Numeric parameters of the BLS12-381 / Jubjub curve family.

Every constant here is either a standard published curve parameter or is
*derived* at import time from one (R, R2, Montgomery inverses, roots of
unity...).  Nothing is transcribed from the reference's Montgomery-form limb
tables; tests cross-check the derived values against the canonical encodings
pinned by the reference test suites (see tests/test_fields.py).

Reference parity: coset-bls12_381/src/scalar.rs, fp.rs; coset-jubjub/src/lib.rs.
"""

# --- BLS12-381 scalar field Fr (the NTT field; "BlsScalar") -----------------
# q = r of BLS12-381: order of the G1/G2 subgroups.
FR_MODULUS = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
FR_BITS = 255
FR_TWO_ADICITY = 32
FR_GENERATOR = 7  # multiplicative generator, also the coset generator for FFTs
# 2^s-th primitive root of unity: g^((q-1)/2^32)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MODULUS - 1) >> FR_TWO_ADICITY, FR_MODULUS)

# Montgomery parameters for the device limb kernels (R = 2^256).
FR_R = (1 << 256) % FR_MODULUS
FR_R2 = (FR_R * FR_R) % FR_MODULUS
FR_R3 = (FR_R2 * FR_R) % FR_MODULUS
# -q^{-1} mod 2^256 (full-width Montgomery constant for SOS reduction)
FR_NPRIME = (-pow(FR_MODULUS, -1, 1 << 256)) % (1 << 256)

# --- BLS12-381 base field Fp -------------------------------------------------
FP_MODULUS = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
FP_BITS = 381
FP_R = (1 << 384) % FP_MODULUS
FP_R2 = (FP_R * FP_R) % FP_MODULUS
FP_NPRIME = (-pow(FP_MODULUS, -1, 1 << 384)) % (1 << 384)

# --- BLS12-381 curve ----------------------------------------------------------
# E(Fp): y^2 = x^3 + 4;  E'(Fp2): y^2 = x^3 + 4(u+1)
G1_B = 4
BLS_X = 0xD201_0000_0001_0000  # |x|; the BLS parameter is -x (x is negative)
BLS_X_IS_NEGATIVE = True

# Standard generator of G1 (canonical integers).
G1_GENERATOR_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GENERATOR_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# Standard generator of G2 (x = x0 + x1*u, y = y0 + y1*u).
G2_GENERATOR_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_GENERATOR_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_GENERATOR_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_GENERATOR_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

# --- Jubjub (embedded twisted Edwards curve over Fr ... note: over Fq = Fr of
# BLS12-381, i.e. the BlsScalar field plays the role of Jubjub's base field) ---
# -u^2 + v^2 = 1 + d u^2 v^2  with d = -(10240/10241)
JUBJUB_D = (-10240 * pow(10241, -1, FR_MODULUS)) % FR_MODULUS
# Jubjub scalar field (prime order of the prime-order subgroup)
JUBJUB_FR_MODULUS = 0x0E7DB4EA6533AFA906673B0101343B00A6682093CCC81082D0970E5ED6F72CB7
JUBJUB_FR_R = (1 << 256) % JUBJUB_FR_MODULUS
JUBJUB_FR_R2 = (JUBJUB_FR_R * JUBJUB_FR_R) % JUBJUB_FR_MODULUS
JUBJUB_FR_TWO_ADICITY = 1
# Dusk generator points (canonical (x, y) affine coordinates); these are the
# published dusk-jubjub constants (GENERATOR and GENERATOR_NUMS).
JUBJUB_GENERATOR_X = 0x3FD2814C43AC65A6F1FBF02D0FD6CCE62E3EBB21FD6C54ED4DF7B7FFEC7BEACA
JUBJUB_GENERATOR_Y = 0x0000000000000000000000000000000000000000000000000000000000000012
JUBJUB_GENERATOR_NUMS_X = 0x5E67B8F316F414F7BD9514C773FD4456931E316A39FE4541921710179DF76377
JUBJUB_GENERATOR_NUMS_Y = 0x43D80EB3B2F3EB1B7B162DBEEB3B34FD9949BA0F82A5507A6705B707162E3EF8

# --- PLONK domain coset constants (plonk/src/permutation/constants.rs:7-9) ---
K1 = 7
K2 = 13
K3 = 17

# --- Poseidon / Hades (coset-poseidon/src/hades.rs:10-14) --------------------
HADES_WIDTH = 5
HADES_FULL_ROUNDS = 8
HADES_PARTIAL_ROUNDS = 60
HADES_ROUNDS = HADES_FULL_ROUNDS + HADES_PARTIAL_ROUNDS
