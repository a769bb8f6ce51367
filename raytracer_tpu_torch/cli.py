"""Command-line front end: `python -m raytracer_tpu_torch.cli`.

Port of raytracer_tpu/cli.py, with every flag of its own. The reference's
front end is an interactive GLUT window whose keyboard edits render
parameters live (MiroWindow, src/MiroWindow.cpp:467-749: FOV 'f', focus 'o',
aperture 'p', paths 'h', bounces 'b', min/max subdivs 'u'/'v', noise 'n',
shutter 'e', path-trace toggle 't', screenshot 'i'). Headless jobs get the
same knobs as flags, the screenshot as a PPM, and the post-render stats
line (src/Scene.cpp:211-216). The port names its device: `--device`
(default cuda; cpu runs the plain tracers); a frame renders in the ray
tile the registry gives its device (registry.frame_tile).

Usage:
  python -m raytracer_tpu_torch.cli --scene sponza_standin --out frame.ppm
"""
from __future__ import annotations

import argparse
import dataclasses
import inspect
import sys
import time

import torch

def _start_preview_server(port: int, out_path: str):
    """Tiny stdlib HTTP preview: / auto-refreshes an <img> of the latest
    progressive batch (out_path + '.png')."""
    import http.server
    import threading

    page = (b'<html><head><title>raytracer_tpu_torch preview</title></head>'
            b'<body style="background:#111;margin:0">'
            b'<img id="f" style="width:100%;image-rendering:pixelated" '
            b'src="/frame.png">'
            b'<script>setInterval(()=>{document.getElementById("f").src='
            b'"/frame.png?"+Date.now();},1000);</script></body></html>')

    class H(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            if self.path.startswith('/frame.png'):
                try:
                    with open(out_path + '.png', 'rb') as f:
                        data = f.read()
                    self.send_response(200)
                    self.send_header('Content-Type', 'image/png')
                except FileNotFoundError:
                    self.send_response(404)
                    data = b''
                    self.send_header('Content-Type', 'text/plain')
            else:
                self.send_response(200)
                data = page
                self.send_header('Content-Type', 'text/html')
            self.send_header('Content-Length', str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, *a):
            pass

    srv = http.server.ThreadingHTTPServer(('127.0.0.1', port), H)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    from .utils import console
    console.info('live preview at http://127.0.0.1:%d/', port)
    return srv


def main(argv=None):
    p = argparse.ArgumentParser(description='raytracer_tpu_torch renderer')
    p.add_argument('--scene', default='triangle_sphere',
                   help='a registry scene (--list-scenes); the asset '
                        "scenes (the JAX package's default, cornell_pt, "
                        'among them) read the tree that RT_ASSETS names')
    p.add_argument('--list-scenes', action='store_true')
    p.add_argument('--size', type=int, default=None, help='square image size')
    p.add_argument('--width', type=int, default=None)
    p.add_argument('--height', type=int, default=None)
    p.add_argument('--spp', type=int, default=4)
    p.add_argument('--adaptive', action='store_true',
                   help='reference-style adaptive supersampling')
    p.add_argument('--seed', type=int, default=3163513)  # reference MT seed
    p.add_argument('--out', default='out.ppm')
    p.add_argument('--fov', type=float, default=None)
    p.add_argument('--focus', type=float, default=None)
    p.add_argument('--aperture', type=float, default=None)
    p.add_argument('--shutter', type=float, default=None)
    p.add_argument('--bounces', type=int, default=None)
    p.add_argument('--min-subdivs', type=int, default=None)
    p.add_argument('--max-subdivs', type=int, default=None)
    p.add_argument('--noise', type=float, default=None)
    p.add_argument('--path-trace', dest='path_trace', default=None,
                   action='store_true')
    p.add_argument('--no-path-trace', dest='path_trace', action='store_false')
    p.add_argument('--brute-force', action='store_true')
    p.add_argument('--progressive', type=int, default=0, metavar='SPP_BATCH',
                   help='render --spp samples in batches of SPP_BATCH, '
                        'rewriting --out and printing a stats line after '
                        'each batch (the reference MiroWindow progressive '
                        'blit, src/MiroWindow.cpp:471-488)')
    p.add_argument('--ckpt', default=None,
                   help='with --progressive: checkpoint path; interrupting '
                        'and rerunning resumes and produces the identical '
                        'final image')
    p.add_argument('--serve', type=int, default=0, metavar='PORT',
                   help='with --progressive: serve a live PNG preview at '
                        'http://localhost:PORT')
    p.add_argument('--device', default='cuda',
                   help='where the scene is built and rendered (default '
                        'cuda, which needs a card; cpu runs the plain '
                        'tracers)')
    args = p.parse_args(argv)

    from .scenes import registry
    if args.list_scenes:
        print('\n'.join(registry.names()))
        return 0

    from . import render, render_adaptive, to_u8
    from .core import rng
    from .io import imageio
    from .utils import console

    kw = {}
    if args.size is not None:
        # a scene of one size takes it; one of width and height takes both
        params = inspect.signature(registry.get(args.scene)).parameters
        kw = dict(size=args.size) if 'size' in params else dict(
            width=args.size, height=args.size)
    scene, cam, settings = registry.make(args.scene, device=args.device, **kw)

    upd = {}
    if args.width:
        upd['width'] = args.width
    if args.height:
        upd['height'] = args.height
    if args.width or args.height:
        # the new frame's tile on the device
        upd['ray_tile'] = registry.frame_tile(
            upd.get('width', settings.width),
            upd.get('height', settings.height), args.device)
    if args.bounces is not None:
        upd['max_bounces'] = args.bounces
        upd['max_wavefront_steps'] = args.bounces + 2
    if args.min_subdivs is not None:
        upd['min_subdivs'] = args.min_subdivs
    if args.max_subdivs is not None:
        upd['max_subdivs'] = args.max_subdivs
    if args.noise is not None:
        upd['noise_threshold'] = args.noise
    if args.path_trace is not None:
        upd['path_trace'] = args.path_trace
    if args.brute_force:
        upd['intersector'] = 'brute'
    settings = dataclasses.replace(settings, **upd)

    cupd = {}
    for flag, field in (('fov', 'fov'), ('focus', 'focus_plane'),
                        ('aperture', 'aperture'), ('shutter', 'shutter')):
        if getattr(args, flag) is not None:
            cupd[field] = torch.tensor(getattr(args, flag),
                                       dtype=torch.float32,
                                       device=cam.eye.device)
    if cupd:
        cam = dataclasses.replace(cam, **cupd)

    key = rng.PRNGKey(args.seed)
    console.info('rendering %s at %dx%d (%s, %d tris) on %s',
                 args.scene, settings.width, settings.height,
                 'adaptive' if args.adaptive else f'{args.spp}spp',
                 scene.num_tris, scene.geom.vertices.device)
    t0 = time.time()
    if args.progressive:
        from .utils import checkpoint as ckpt_mod
        server = _start_preview_server(args.serve, args.out) \
            if args.serve else None
        W, H = settings.width, settings.height

        def on_batch(mean_img, done, total):
            u8 = to_u8(torch.from_numpy(mean_img)).numpy()
            imageio.write_ppm(args.out, u8)
            if server is not None:
                imageio.write_png(args.out + '.png', u8)
            spp_done = done * args.progressive
            console.info('progressive: %d/%d spp  %.1fs elapsed  '
                         '(%.0f rays/s)  -> %s', spp_done, args.spp,
                         time.time() - t0,
                         W * H * spp_done / (time.time() - t0), args.out)

        img = ckpt_mod.render_progressive(
            scene, cam, settings, key, spp_total=args.spp,
            spp_batch=args.progressive, ckpt_path=args.ckpt,
            on_batch=on_batch)
    elif args.adaptive:
        img = render_adaptive(scene, cam, settings, key)
    else:
        img = render(scene, cam, settings, key, spp=args.spp)
    u8 = to_u8(img).cpu().numpy()
    dt = time.time() - t0
    rays = settings.width * settings.height * (
        sum(k * k for k in range(1, settings.max_subdivs + 1))
        if args.adaptive else args.spp)
    console.info('done in %.3fs (%.0f primary rays/s incl. kernel builds)',
                 dt, rays / dt)
    imageio.write_ppm(args.out, u8)
    console.info('wrote %s', args.out)
    return 0


if __name__ == '__main__':
    sys.exit(main())
