"""Scene registry (port of rtw_tpu/models/registry.py): the reference's 5
hard-coded scenes (ioScene.h:74-93) rebuilt declaratively with their literal
constants, plus a small dev scene (BASELINE config #1).

Scene-construction randomness uses the bit-exact xorshift32 streams and
literal seeds of the reference (MovingSpheres 0x314759, ioScene.h:201;
InOneWeekendLight / TheNextWeekFinal 0x6314759, ioScene.h:367,803) so the
random geometry matches primitive-for-primitive.

DoF note (SURVEY §7.4 quirk 2): the reference specifies per-scene apertures
but never uploads the lens radius, so its renders have no depth of field.
`dof="reference"` (default) reproduces that (lens radius 0); `dof="book"`
wires the literal apertures.
"""

from __future__ import annotations

import os

import numpy as np

from . import scene as S
from .builder import (SceneBuilder, translate, rotate_y,
                                    rotate_z, ASSET_DIR)
from .rng import XorShift32

SCENE_NAMES = {
    0: "Cornell box",
    1: "InOneWeekend final scene with moving spheres",
    2: "IOW Scene with a light box",
    3: "Cornell box with volumes (participating media)",
    4: "The Next Week final scene",
    5: "Three-sphere dev scene (lambertian+metal+dielectric)",
}

EARTHMAP = os.path.join(ASSET_DIR, "earthmap.jpg")


def _aperture(dof: str, book_value: float) -> float:
    if dof == "book":
        return book_value
    if dof == "reference":
        return 0.0
    raise ValueError(f"dof must be 'reference' or 'book', got {dof!r}")


# ---------------------------------------------------------------------------
# Scene 0: Cornell box (ioScene.h:491-627)
# ---------------------------------------------------------------------------

def cornell_box(aspect: float, dof: str = "reference") -> S.Scene:
    b = SceneBuilder()
    wall_red = b.lambertian(b.constant_texture((0.65, 0.05, 0.05)))
    wall_green = b.lambertian(b.constant_texture((0.12, 0.45, 0.15)))
    wall_white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    aluminum = b.metal(b.constant_texture((0.91, 0.92, 0.92)), 0.018)
    light15_tex = b.constant_texture((15.0, 15.0, 15.0))
    light15 = b.diffuse_light(light15_tex)
    glass = b.dielectric(1.5)

    b.sphere((190.0, 90.0, 190.0), 90.0, glass)
    b.rect(0, 555, 0, 555, 555, True, S.AXIS_X, wall_green)   # left
    b.rect(0, 555, 0, 555, 0, False, S.AXIS_X, wall_red)      # right
    b.rect(0, 555, 0, 555, 555, True, S.AXIS_Y, wall_white)   # roof
    b.rect(0, 555, 0, 555, 0, False, S.AXIS_Y, wall_white)    # floor
    b.rect(0, 555, 0, 555, 555, True, S.AXIS_Z, wall_white)   # back
    b.rect(213, 343, 227, 332, 554.9, True, S.AXIS_Y, light15)

    # rotated aluminum box: translate(265,0,295) @ rotateY(15)
    # (ioScene.h:534-548)
    xf = translate((265.0, 0.0, 295.0)) @ rotate_y(15.0)
    b.box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), aluminum, transform=xf)

    b.add_light(position=(213.0, 554.0, 227.0),
                vec_u=(343.0 - 213.0, 0.0, 0.0),
                vec_v=(0.0, 0.0, 332.0 - 227.0),
                emission=(15.0, 15.0, 15.0), tex=light15_tex)

    b.set_camera((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, aspect,
                 _aperture(dof, 1.0), 10.0, t0=0.0, t1=1.0)
    return b.build()


# ---------------------------------------------------------------------------
# Scenes 1 & 2 share the random small-sphere field (ioScene.h:200-253,366-417)
# ---------------------------------------------------------------------------

def _small_spheres(b: SceneBuilder, rng: XorShift32, moving: bool):
    for a in range(-11, 11):
        for bb in range(-11, 11):
            choose = rng.randf()
            x = a + 0.8 * rng.randf()
            y = 0.2
            z = bb + 0.9 * rng.randf()
            z2 = z * z
            dist = np.sqrt((x - 4.0) ** 2 + z2)
            if (dist > 0.9) or ((z2 > 0.7) and ((x * x - 16.0) > -2.0)):
                if choose < 0.70:
                    albedo = b.constant_texture((rng.randf(), rng.randf(), rng.randf()))
                    mat = b.lambertian(albedo)
                    if moving:
                        b.moving_sphere((x, y, z), (x, y + 0.18, z), 0.2,
                                        0.0, 1.0, mat)
                    else:
                        b.sphere((x, y, z), 0.2, mat)
                elif choose < 0.85:
                    col = (0.5 * (1.0 - rng.randf()), 0.5 * (1.0 - rng.randf()),
                           0.5 * (1.0 - rng.randf()))
                    mat = b.metal(b.constant_texture(col), 0.5 * rng.randf())
                    b.sphere((x, y, z), 0.2, mat)
                elif choose < 0.93:
                    b.sphere((x, y, z), 0.2, b.dielectric(1.5))
                else:
                    b.sphere((x, y, z), 0.2, b.dielectric(1.5))
                    b.sphere((x, y, z), 0.2 - 0.007, b.dielectric(1.5))


def moving_spheres(aspect: float, dof: str = "reference") -> S.Scene:
    """Scene 1 (ioScene.h:180-309)."""
    b = SceneBuilder()
    grey = b.constant_texture((0.5, 0.5, 0.5))
    reddish_grey = b.constant_texture((0.7, 0.6, 0.5))
    reddish = b.constant_texture((0.4, 0.2, 0.1))

    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(grey))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.dielectric(1.5))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.lambertian(reddish))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.metal(reddish_grey, 0.1))

    _small_spheres(b, XorShift32(0x314759), moving=True)

    b.set_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect,
                 _aperture(dof, 0.1), 10.0, t0=0.0, t1=1.0)
    return b.build()


def in_one_weekend_light(aspect: float, dof: str = "reference",
                         light_variant: str = "live") -> S.Scene:
    """Scene 2 (ioScene.h:313-489).

    NEE divergence (documented): the reference's PDF-tree rect for this scene
    is {3,5,2.3,6,-2} (ioScene.h:125) while the actual light rect is
    {3,5,1,3,-2} (ioScene.h:351) — its NEE samples points mostly *off* the
    light yet still credits emission.  We sample the true light rect.

    `light_variant="sky_y10"` builds the ALTERNATIVE illumination that is
    commented out in the reference source (ioScene.h:363-364: an overhead
    y=10 rect with the dimmer (4,4,4) `light4` emitter, no z=-2 rect) —
    used only by tools/scene2_archaeology.py to test PARITY.md's hypothesis
    that the committed reference PNG was rendered from this variant.
    """
    b = SceneBuilder()
    grey = b.constant_texture((0.7, 0.7, 0.7))
    noise1 = b.noise_texture(1.0)
    earth = b.image_texture(EARTHMAP)

    b.sphere((0.0, -1000.0, 0.0), 1000.0, b.lambertian(noise1))
    b.sphere((-4.0, 1.0, 0.0), 1.0, b.metal(grey, 0.4))
    b.sphere((0.0, 1.0, 0.0), 1.0, b.lambertian(earth))
    b.sphere((4.0, 1.0, 0.0), 1.0, b.dielectric(1.5))

    if light_variant == "sky_y10":
        light4 = b.constant_texture((4.0, 4.0, 4.0))
        b.rect(-6.0, -1.0, -2.0, 2.0, 10.0, True, S.AXIS_Y,
               b.diffuse_light(light4))
        b.add_light(position=(-6.0, 10.0, -2.0),
                    vec_u=(5.0, 0.0, 0.0), vec_v=(0.0, 0.0, 4.0),
                    emission=(4.0, 4.0, 4.0), tex=light4)
    else:
        light16 = b.constant_texture((16.0, 16.0, 16.0))
        b.rect(3.0, 5.0, 1.0, 3.0, -2.0, False, S.AXIS_Z,
               b.diffuse_light(light16))
        b.add_light(position=(3.0, 1.0, -2.0),
                    vec_u=(2.0, 0.0, 0.0), vec_v=(0.0, 2.0, 0.0),
                    emission=(16.0, 16.0, 16.0), tex=light16)

    _small_spheres(b, XorShift32(0x6314759), moving=False)

    b.set_camera((13, 2, 3), (0, 0, 0), (0, 1, 0), 20.0, aspect,
                 _aperture(dof, 0.08), 10.0)
    return b.build()


# ---------------------------------------------------------------------------
# Scene 3: Cornell box with volumes (ioScene.h:630-788)
# ---------------------------------------------------------------------------

def volumes_cornell_box(aspect: float, dof: str = "reference") -> S.Scene:
    b = SceneBuilder()
    wall_red = b.lambertian(b.constant_texture((0.65, 0.05, 0.05)))
    wall_green = b.lambertian(b.constant_texture((0.12, 0.45, 0.15)))
    wall_white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    light15 = b.diffuse_light(b.constant_texture((15.0, 15.0, 15.0)))
    black_fog = b.isotropic(b.constant_texture((0.0, 0.0, 0.0)))
    white_fog = b.isotropic(b.constant_texture((1.0, 1.0, 1.0)))

    b.rect(0, 555, 0, 555, 555, True, S.AXIS_X, wall_green)
    b.rect(0, 555, 0, 555, 0, False, S.AXIS_X, wall_red)
    b.rect(0, 555, 0, 555, 555, True, S.AXIS_Y, wall_white)
    b.rect(0, 555, 0, 555, 0, False, S.AXIS_Y, wall_white)
    b.rect(0, 555, 0, 555, 555, True, S.AXIS_Z, wall_white)
    b.rect(213, 343, 227, 332, 554.0, True, S.AXIS_Y, light15)

    # black-fog box: translate(265, |sin(-12.5deg)|*165, 255) @ rotZ(-12.5)
    # @ rotY(15)  (ioScene.h:693-720)
    z1 = -12.5
    lift = abs(np.sin(np.deg2rad(z1))) * 165.0
    xf = translate((265.0, lift, 255.0)) @ rotate_z(z1) @ rotate_y(15.0)
    b.volume_box((0.0, 0.0, 0.0), (165.0, 330.0, 165.0), 0.006, black_fog,
                 transform=xf)

    # white-fog sphere: object center (82.5, 75, 82.5) translated by
    # (130, 0, 65) (ioScene.h:751-758) -> world (212.5, 75, 147.5)
    b.volume_sphere((82.5, 75.0, 82.5), 75.0, 0.005, white_fog,
                    transform=translate((130.0, 0.0, 65.0)))

    # NOTE: the reference registers NO LightDefinition for this scene
    # (ioScene.h:630-788) -> numLights=0 -> skyLight on (Director.cpp:523):
    # no NEE, and the open Cornell front admits the sky gradient.  Replicated.

    b.set_camera((278, 278, -800), (278, 278, 0), (0, 1, 0), 40.0, aspect,
                 _aperture(dof, 0.1), 10.0)
    return b.build()


# ---------------------------------------------------------------------------
# Scene 4: The Next Week final (ioScene.h:791-982)
# ---------------------------------------------------------------------------

def the_next_week_final(aspect: float, dof: str = "reference") -> S.Scene:
    b = SceneBuilder()
    brown = b.constant_texture((0.7, 0.3, 0.1))
    ground_green = b.constant_texture((0.48, 0.83, 0.53))
    metal1 = b.constant_texture((0.8, 0.8, 0.9))
    noise_p1 = b.noise_texture(0.1)
    earth = b.image_texture(EARTHMAP)
    light7 = b.constant_texture((7.0, 7.0, 7.0))

    rng = XorShift32(0x6314759)

    glassy_blue_fog = b.isotropic(b.constant_texture((0.2, 0.4, 0.9)))
    ambient_fog = b.isotropic(b.constant_texture((0.95, 0.95, 0.95)))
    ground = b.lambertian(ground_green)

    b.rect(123, 423, 147, 412, 554.0, True, S.AXIS_Y, b.diffuse_light(light7))
    b.add_light(position=(123.0, 554.0, 147.0),
                vec_u=(300.0, 0.0, 0.0), vec_v=(0.0, 0.0, 265.0),
                emission=(7.0, 7.0, 7.0), tex=light7)

    b.sphere((260.0, 150.0, 45.0), 50.0, b.dielectric(1.5))       # glass
    b.sphere((0.0, 150.0, 145.0), 50.0, b.metal(metal1, 0.2))     # metal
    b.sphere((360.0, 150.0, 45.0), 70.0, b.dielectric(1.5))       # blue glassy
    b.sphere((0.0, 0.0, 0.0), 5000.0, b.dielectric(1.5))          # room boundary
    b.sphere((400.0, 200.0, 400.0), 100.0, b.lambertian(earth))   # earth
    b.sphere((220.0, 280.0, 300.0), 80.0, b.lambertian(noise_p1))  # marble
    b.moving_sphere((400.0, 400.0, 200.0), (430.0, 400.0, 200.0), 50.0,
                    0.0, 1.0, b.lambertian(brown))

    # 20x20 random-height ground boxes (ioScene.h:887-923)
    for i in range(20):
        for j in range(20):
            w = 100.0
            x0 = -1000.0 + i * w
            z0 = -1000.0 + j * w
            x1 = x0 + w
            y1 = 100.0 * (rng.randf() + 0.01)
            z1 = z0 + w
            b.box((x0, 0.0, z0), (x1, y1, z1), ground)

    # volumes (ioScene.h:924-932)
    b.volume_sphere((360.0, 150.0, 45.0), 70.0, 0.2, glassy_blue_fog)
    b.volume_sphere((0.0, 0.0, 0.0), 500.0, 8e-5, ambient_fog)

    # 1000 instanced white spheres: translate(-100,270,395) @ rotY(20)
    # (ioScene.h:934-946); rigid -> centers pre-baked by the builder
    white = b.lambertian(b.constant_texture((0.93, 0.93, 0.93)))
    xf = translate((-100.0, 270.0, 395.0)) @ rotate_y(20.0)
    for _ in range(1000):
        c = (165.0 * rng.randf(), 165.0 * rng.randf(), 165.0 * rng.randf())
        b.sphere(c, 10.0, white, transform=xf)

    b.set_camera((478, 278, -600), (278, 278, 0), (0, 1, 0), 40.0, aspect,
                 _aperture(dof, 0.1), 10.0, t0=0.0, t1=1.0)
    return b.build()


# ---------------------------------------------------------------------------
# Scene 5 (extra): three-sphere dev scene — BASELINE config #1
# ---------------------------------------------------------------------------

def three_sphere(aspect: float, dof: str = "reference") -> S.Scene:
    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.8, 0.8, 0.0)))
    center = b.lambertian(b.constant_texture((0.1, 0.2, 0.5)))
    right = b.metal(b.constant_texture((0.8, 0.6, 0.2)), 0.05)
    glass = b.dielectric(1.5)

    b.sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.sphere((0.0, 0.0, -1.0), 0.5, center)
    b.sphere((1.0, 0.0, -1.0), 0.5, right)
    b.sphere((-1.0, 0.0, -1.0), 0.5, glass)

    b.set_camera((3, 3, 2), (0, 0, -1), (0, 1, 0), 20.0, aspect,
                 _aperture(dof, 0.1), float(np.linalg.norm([3, 3, 3])))
    return b.build()


# ---------------------------------------------------------------------------
# The scale tier's stress field (tools/stress_scale.py of the reference)
# ---------------------------------------------------------------------------

def build_stress_scene(n_spheres: int, light: bool = False,
                       device="cuda", chunk_size: int = 64) -> S.Scene:
    """`n_spheres` grey lambertian spheres, centres uniform in the 400-unit
    cube, radii 1-5 (numpy seed 5), seen from (0, 0, -500) at vfov 40 under
    the sky: the reference's scale-ceiling probe.  `light` adds one emissive
    rect above the field with its NEE light, so shadow rays cross the field
    (no counterpart in the reference's tool).  `chunk_size` is
    `SceneBuilder.build`'s prims per block.  On `device`, as `build_scene`."""
    device = S.scene_device(device, "build_stress_scene")
    b = SceneBuilder()
    rng = np.random.default_rng(5)
    mat = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    centers = rng.uniform(-200, 200, (n_spheres, 3))
    radii = rng.uniform(1.0, 5.0, n_spheres)
    for c, r in zip(centers, radii):
        b.sphere(c, float(r), mat)
    if light:
        light_tex = b.constant_texture((15.0, 15.0, 15.0))
        b.rect(-100.0, 100.0, -100.0, 100.0, 260.0, True, S.AXIS_Y,
               b.diffuse_light(light_tex))
        b.add_light(position=(-100.0, 260.0, -100.0),
                    vec_u=(200.0, 0.0, 0.0), vec_v=(0.0, 0.0, 200.0),
                    emission=(15.0, 15.0, 15.0), tex=light_tex)
    b.set_camera(lookfrom=(0, 0, -500), lookat=(0, 0, 0), vup=(0, 1, 0),
                 vfov=40.0, aspect=1.0, aperture=0.0, focus_dist=10.0)
    return b.build(chunk_size).to(device)


_BUILDERS = {
    0: cornell_box,
    1: moving_spheres,
    2: in_one_weekend_light,
    3: volumes_cornell_box,
    4: the_next_week_final,
    5: three_sphere,
}


def build_scene(scene_id: int, nx: int, ny: int, dof: str = "reference",
                device="cuda") -> S.Scene:
    """Scene `scene_id` framed for an nx x ny image, its tensors on
    `device`: the card unless the caller asks for the CPU.  A render runs
    on its scene's device.  Where CUDA is absent the default raises; it
    never builds on the CPU in its place."""
    if scene_id not in _BUILDERS:
        raise ValueError(f"ERROR: Scene {scene_id} unknown.")
    device = S.scene_device(device, "build_scene")
    return _BUILDERS[scene_id](float(nx) / float(ny), dof=dof).to(device)
