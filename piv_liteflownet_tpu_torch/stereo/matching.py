"""Calibration-plate cross detection: template matching and local maxima.

Port of ``piv_liteflownet_tpu/stereo/matching.py``:

- ``gen_template``: the synthetic cross template (numpy, copied);
- ``template_matching``: the port's own ``cv2.matchTemplate(...,
  TM_CCOEFF_NORMED)`` on the zero-padded frame, thresholded, then
  ``cv2.blur(res, (2, 2))``, in float64 with torch on the frame's device: the
  numerator a correlation with the mean-free template by FFT, the window sums
  of I and I^2 from integral images. It needs no OpenCV;
- ``find_local_max``: connected-component centroids (scipy ``ndimage`` on
  the host, copied);
- ``select_ref_points`` (scripted) and ``select_ref`` (interactive, with
  matplotlib imported when called), copied.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

#: float32's machine epsilon, in OpenCV's test for a flat window.
FLT_EPSILON = float(np.finfo(np.float32).eps)


def gen_template(TC: int = 5, HC: int = 25, LC: int = 25) -> np.ndarray:
    """Cross template image, uint8 grayscale. TC = cross thickness."""
    template = np.zeros((HC, LC))
    hc2, lc2 = int(np.ceil(HC / 2)), int(np.ceil(LC / 2))
    tc2 = int(np.floor(TC / 2))
    if TC % 2:  # odd thickness
        template[hc2 - tc2 - 1 : hc2 + tc2, :] = 1.0
        template[:, lc2 - tc2 - 1 : lc2 + tc2] = 1.0
    else:
        template[hc2 - tc2 - 1 : hc2 + tc2 - 1, :] = 1.0
        template[:, lc2 - tc2 - 1 : lc2 + tc2] = 1.0
    return (template * 255).astype(np.uint8)


def _window_sums(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    """The sum of every ``th x tw`` window of ``x`` (valid positions), from its integral image:
    exact in float64 for 8-bit values and their squares."""
    s = F.pad(x.cumsum(0).cumsum(1), (1, 0, 1, 0))
    return s[th:, tw:] - s[:-th, tw:] - s[th:, :-tw] + s[:-th, :-tw]


def _correlate_valid(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """``sum_ij x[y+i, x+j] * k[i, j]`` at every valid position, in float64 through 2-D FFTs of
    ``x``'s size (the valid part of the circular convolution with the flipped kernel does not
    wrap). A direct float64 ``conv2d`` unfolds the frame first: 5.5 GB for a 25x25 template on
    a 1024^2 frame on the CPU."""
    h, w = x.shape
    kh, kw = k.shape
    spectrum = torch.fft.rfft2(x) * torch.fft.rfft2(k.flip(0, 1), s=(h, w))
    return torch.fft.irfft2(spectrum, s=(h, w))[kh - 1:, kw - 1:]


def _ccoeff_normed(img: torch.Tensor, tpl: torch.Tensor) -> torch.Tensor:
    """``cv2.matchTemplate(img, tpl, cv2.TM_CCOEFF_NORMED)`` in float64, rounded to float32 as
    OpenCV stores it: ``sum(T' I) / (sqrt(sum I^2 - (sum I)^2 / n) * ||T'||)`` with ``T'`` the
    mean-free template, OpenCV's rules at the edges of the quotient kept (a flat window gives 0,
    a quotient a little above 1 from rounding gives +-1)."""
    th, tw = tpl.shape
    n = th * tw
    tz = tpl - tpl.mean()
    templ_norm = float(torch.sqrt((tz * tz).sum()))
    out_shape = (img.shape[0] - th + 1, img.shape[1] - tw + 1)
    if templ_norm < np.finfo(np.float64).eps:  # a flat template: OpenCV answers 1 everywhere
        return torch.ones(out_shape, dtype=torch.float32, device=img.device)
    num = _correlate_valid(img, tz)
    wnd_sum = _window_sums(img, th, tw)
    wnd_sum2 = _window_sums(img * img, th, tw)
    diff2 = torch.clamp(wnd_sum2 - wnd_sum * wnd_sum * (1.0 / n), min=0.0)
    flat = diff2 <= torch.clamp(10 * FLT_EPSILON * wnd_sum2, max=0.5)
    t = torch.where(flat, 0.0, torch.sqrt(diff2) * templ_norm)
    mag = num.abs()
    res = torch.where(mag < t, num / torch.where(flat, 1.0, t),
                      torch.where(mag < t * 1.125, torch.sign(num), 0.0))
    return res.float()


def _blur2x2(res: torch.Tensor) -> torch.Tensor:
    """``cv2.blur(res, (2, 2))``: ``out[y,x] = mean(res[y-1:y+1, x-1:x+1])``, the row and column
    before the first reflected without the edge (OpenCV's ``BORDER_REFLECT_101``), summed in
    float64 and stored as float32."""
    p = F.pad(res.double()[None, None], (1, 0, 1, 0), mode="reflect")[0, 0]
    rows = p[:, :-1] + p[:, 1:]
    return ((rows[:-1] + rows[1:]) * 0.25).float()


def template_matching(gray_img, template: np.ndarray, threshold: float = 0.0) -> torch.Tensor:
    """Zero-pad, normalized-ccoeff template match, threshold, 2x2 blur.

    ``gray_img``: ``[H,W]`` 8-bit grey values, a tensor (the match runs on its device) or a
    numpy array (on the CPU); other dtypes are cast to uint8 first, as the JAX package's
    padded uint8 frame takes them. Returns the float32 ``[H,W]`` map (for an odd template).
    """
    img = torch.as_tensor(gray_img)
    tpl = torch.as_tensor(np.asarray(template), device=img.device).to(torch.uint8).double()
    pad = [int((tpl.shape[0] - 1) / 2), int((tpl.shape[1] - 1) / 2)]
    padded = F.pad(img.to(torch.uint8).double(), (pad[1], pad[1], pad[0], pad[0]))
    res = _ccoeff_normed(padded, tpl)
    res = res * (res > threshold)
    return _blur2x2(res)


def find_local_max(image) -> np.ndarray:
    """Connected-component centroids of the thresholded correlation map (a tensor is copied to
    the host), returned as [N, 2] (x, y)."""
    from scipy import ndimage

    if isinstance(image, torch.Tensor):
        image = image.cpu().numpy()
    lbl, n = ndimage.label(image)
    points = ndimage.center_of_mass(image, lbl, list(range(1, n + 1)))
    return np.fliplr(np.asarray(points, np.float64).reshape(-1, 2))


def select_ref_points(coords: np.ndarray, clicks: List[Tuple[float, float]]):
    """Snap 4 approximate (clicked) positions to the nearest detected points.

    Returns (points_ref [4,2], selected_indices, center_point) with the
    reference's center computation.
    """
    coords = np.asarray(coords, np.float64)
    selected = []
    for click in clicks:
        d = np.linalg.norm(coords - np.asarray(click, np.float64), axis=1)
        selected.append(int(np.argmin(d)))
    points_ref = coords[selected]
    c_x = (abs(points_ref[1, 0] - points_ref[0, 0]) + abs(points_ref[3, 0] - points_ref[2, 0])) * 0.5
    c_y = (abs(points_ref[3, 1] - points_ref[0, 1]) + abs(points_ref[2, 1] - points_ref[1, 1])) * 0.5
    return points_ref, selected, [c_x, c_y]


def select_ref(coords: np.ndarray):
    """Interactive 4-point picking via matplotlib ginput (clockwise L-R-D-L). Requires a
    display and matplotlib."""
    import matplotlib.pyplot as plt

    clicks = []
    for i in range(4):
        pt = plt.ginput(1, timeout=-1, show_clicks=True)[0]
        print(f"\t{i + 1}. Clicked at {pt}")
        clicks.append(pt)
    points_ref, selected, c_point = select_ref_points(coords, clicks)
    for i in range(4):
        j = (i + 1) % 4
        plt.plot([points_ref[i, 0], points_ref[j, 0]], [points_ref[i, 1], points_ref[j, 1]], "r-")
        plt.plot(points_ref[i, 0], points_ref[i, 1], "yo")
    return points_ref, selected, c_point
