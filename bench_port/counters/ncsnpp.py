"""Model FLOPs of NCSN++, counted from the configuration's shapes.

Counted: every convolution (2·Cin·Cout·k²·Hout·Wout per image), every
dense layer and channel projection (2·in·out per row), attention's two
products (2·N²·C each), and the FIR resampling as its separable
formulation, two depthwise passes of the 4 taps over the zero-inserted
and padded input (upfirdn2d). Normalization, activations, additions and
the time embedding's sines are not counted. This is what
``torch.utils.flop_counter.FlopCounterMode`` counts for a forward of the
network written this way.

A training step counts three forwards (each product's input and weight
gradients cost two more).
"""
from __future__ import annotations

TRAIN_FACTOR = 3


def _conv(cin, cout, k, h, w):
  return 2 * cin * cout * k * k * h * w


def _fir_up(c, res):
  # rows: zero-inserted 2·res (+3 padding) filtered to 2·res, width res;
  # then the width likewise: 2·res × 2·res.
  return 2 * c * 4 * (2 * res * res + 4 * res * res)


def _fir_down(c, res):
  # stride 2 along each axis after a pad of one on each side.
  return 2 * c * 4 * (res // 2 * res + res // 2 * (res // 2))


def _fir_pad2(c, res):
  # the fused downsampler's filter: pad two on each side, stride one,
  # res + 1 rows and columns out.
  return 2 * c * 4 * ((res + 1) * res + (res + 1) * (res + 1))


def _attention(c, res):
  n = res * res
  return 4 * 2 * n * c * c + 2 * 2 * n * n * c


def forward_flops(config: dict, batch: int = 1) -> int:
  """FLOPs of one NCSN++ forward at ``batch`` images."""
  m, data = config["model"], config["data"]
  nf, ch_mult, nrb = m["nf"], tuple(m["ch_mult"]), m["num_res_blocks"]
  attn_res = tuple(m["attn_resolutions"])
  res0, chans = data["image_size"], data["num_channels"]
  nres = len(ch_mult)
  temb = 4 * nf
  total = 2 * (2 * nf) * temb + 2 * temb * temb
  total += _conv(chans, nf, 3, res0, res0)

  def resblock(cin, cout, res, up=False, down=False):
    cout = cout or cin
    out = res * 2 if up else res // 2 if down else res
    f = 0
    if up:
      f += 2 * _fir_up(cin, res)
    if down:
      f += 2 * _fir_down(cin, res)
    f += _conv(cin, cout, 3, out, out) + 2 * temb * cout
    f += _conv(cout, cout, 3, out, out)
    if cin != cout or up or down:
      f += _conv(cin, cout, 1, out, out)
    return f

  hs_c, cin, pyr_ch, res = [nf], nf, chans, res0
  for i in range(nres):
    for _ in range(nrb):
      total += resblock(cin, nf * ch_mult[i], res)
      cin = nf * ch_mult[i]
      if res in attn_res:
        total += _attention(cin, res)
      hs_c.append(cin)
    if i != nres - 1:
      total += resblock(cin, None, res, down=True)
      if m["progressive_input"] == "input_skip":
        total += _fir_down(chans, res) + _conv(chans, cin, 1, res // 2,
                                                res // 2)
      elif m["progressive_input"] == "residual":
        total += _fir_pad2(pyr_ch, res) + _conv(pyr_ch, cin, 3, res // 2,
                                                 res // 2)
        pyr_ch = cin
      else:
        raise NotImplementedError(m["progressive_input"])
      res //= 2
      hs_c.append(cin)
  total += 2 * resblock(cin, None, res) + _attention(cin, res)
  first = True
  for i in reversed(range(nres)):
    for _ in range(nrb + 1):
      cskip = hs_c.pop()
      total += resblock(cin + cskip, nf * ch_mult[i], res)
      cin = nf * ch_mult[i]
    if res in attn_res:
      total += _attention(cin, res)
    if m["progressive"] == "output_skip":
      total += _conv(cin, chans, 3, res, res)
      if not first:
        total += _fir_up(chans, res // 2)
    elif m["progressive"] != "none":
      raise NotImplementedError(m["progressive"])
    first = False
    if i != 0:
      total += resblock(cin, None, res, up=True)
      res *= 2
  if m["progressive"] == "none":
    total += _conv(cin, chans, 3, res, res)
  return batch * total
